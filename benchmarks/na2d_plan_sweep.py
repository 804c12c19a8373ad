#!/usr/bin/env python3
"""Times every launch plan of the NA2D kernels (K1, K2's two passes) at the
codec's NATTEN shapes on one CUDA card, to choose the plans' score
(``flocoder_torch/ops/kernels/na2d.py``: ``query_plans``, ``key_plans``).

    python benchmarks/na2d_plan_sweep.py [--warps 2,4,8] [--out FILE]

For each shape (B=64: 32²×512, 16²×1024, 16²×128; 8 heads, k=7) and dtype
(fp32, bf16), each plan is forced on the wrapper and timed by the
profiler's device time of the kernel it plans (K1, K2's pass 1 or pass 2),
5 calls after a warm one. Prints one line per plan, marks the plan the
score picks, and writes all of them as JSON lines to ``--out``. Fails
without a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(64, 32, 32, 512, 8), (64, 16, 16, 1024, 8), (64, 16, 16, 128, 8)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default="2,4,8", help="warps per block to try")
    ap.add_argument("--out", default=None, help="file to write the JSON lines to")
    args = ap.parse_args()
    warps_ok = {int(w) for w in args.warps.split(",")}
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        sys.exit("na2d_plan_sweep: torch.cuda.is_available() is false: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from flocoder_torch.ops.kernels import na2d as kna

    card = smoke.card_line()
    print(card, flush=True)
    kna.na2d_fwd.build()
    kna.na2d_bwd.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(7)
    rows = []
    pick_q, pick_k = kna.plan_queries, kna.plan_keys
    for B, H, W, C, heads in SHAPES:
        dh = C // heads
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v, gr = (torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
                           for _ in range(4))
            o = kna.na2d_fwd(q, k, v, kernel_size=7, heads=heads)
            fwd = lambda: kna.na2d_fwd(q, k, v, kernel_size=7, heads=heads)  # noqa: E731
            bwd = lambda: kna.na2d_bwd(q, k, v, o, gr, kernel_size=7, heads=heads)  # noqa: E731
            chosen = {"na2d_fwd": pick_q(H, W, dh, 7, bf16),
                      "na2d_bwd pass 1": pick_q(H, W, dh, 7, bf16),
                      "na2d_bwd pass 2": pick_k(H, W, dh, 7, bf16)}
            jobs = []
            for name, plans, fn, key in (
                    ("na2d_fwd", kna.query_plans(H, W, dh, 7, bf16), fwd, "na2d_fwd"),
                    ("na2d_bwd pass 1", kna.query_plans(H, W, dh, 7, bf16), bwd, "na2d_bwd_dq"),
                    ("na2d_bwd pass 2", kna.key_plans(H, W, dh, 7, bf16), bwd, "na2d_bwd_dkv")):
                jobs += [(name, score, p, fn, key) for score, p in plans
                         if (p.tile_h // 4) * (p.tile_w // 4) in warps_ok]
            for name, score, p, fn, key in jobs:
                if name == "na2d_bwd pass 2":
                    kna.plan_queries = pick_q
                    kna.plan_keys = lambda *a, _p=p: _p
                else:
                    kna.plan_queries = lambda *a, _p=p: _p
                    kna.plan_keys = pick_k
                try:
                    ms = smoke.device_ms(fn, key, iters=5)
                finally:
                    kna.plan_queries, kna.plan_keys = pick_q, pick_k
                row = dict(kernel=name, shape=[B, H, W, C], dtype=str(dtype)[6:],
                           plan=p._asdict(), score=list(score), device_ms=ms,
                           picked=p == chosen[name])
                rows.append(row)
                print(f"{name} B={B} {H}x{W} C={C} {row['dtype']} tile {p.tile_h}x{p.tile_w} "
                      f"{'two_buf ' if getattr(p, 'two_buf', 0) else ''}smem {p.smem}: "
                      f"{ms:.4f} ms{'  <- picked' if row['picked'] else ''}", flush=True)
            del q, k, v, gr, o
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(dict(r, card=card)) + "\n")


if __name__ == "__main__":
    main()

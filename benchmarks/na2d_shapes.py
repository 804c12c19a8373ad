#!/usr/bin/env python3
"""Times the NA2D kernels K1 and K2 of a checkout of flocoder_torch at the
codec's NATTEN shapes, on one CUDA card, with ``chip_smoke.time_na2d_shapes``
(device time by the profiler, CUDA events, and each shape's bound).

    python benchmarks/na2d_shapes.py [--root DIR] [--label NAME] [--out FILE]

``--root`` names the checkout whose ``flocoder_torch`` is built and timed
(default: this one), for instance an unpacked ``git archive`` of an earlier
commit; ``chip_smoke.py`` always comes from this checkout. To compare two
versions on one card, run them in turns in one session (earlier, this,
this, earlier). Prints the card line and one JSON object, and appends the
JSON to ``--out`` when given. Fails without a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose flocoder_torch to time")
    ap.add_argument("--label", default=None, help="name of the run in the JSON")
    ap.add_argument("--out", default=None, help="file to append the JSON line to")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        sys.exit("na2d_shapes: torch.cuda.is_available() is false: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from flocoder_torch.ops.kernels.na2d import na2d_bwd, na2d_fwd
    if not os.path.abspath(sys.modules["flocoder_torch"].__file__).startswith(root + os.sep):
        sys.exit(f"na2d_shapes: flocoder_torch did not come from {root}")

    card = smoke.card_line()
    t0 = time.time()
    na2d_fwd.build()
    na2d_bwd.build()
    build_s = time.time() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = smoke.time_na2d_shapes(na2d_fwd, na2d_bwd, card)
    res = {"label": args.label or root, "card": card, "build_s": build_s, "rows": rows}
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(card)
    print(line)


if __name__ == "__main__":
    main()

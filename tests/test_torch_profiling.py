"""The port's profiling helpers (flocoder_torch.utils.profiling), the torch
counterparts of the JAX module's four names: ``print_mem`` (nothing to
report without a card; ``chip_smoke.py`` reads the card's), ``trace``
(a torch.profiler region whose handler writes a trace file into the
directory), ``step_timer`` (seconds set at the end, one synchronise) and
``enable_nan_debugging`` (autograd's anomaly mode with NaN checks: a
backward that makes a NaN raises and names its operation, a forward NaN
alone does not, where ``jax_debug_nans`` would; ROADMAP.md §3).
"""
import json
import os

import pytest
import torch

from flocoder_tpu.utils import profiling as jprof
from flocoder_torch.utils import profiling as tprof


def test_same_names_as_the_jax_module():
    assert set(tprof.__all__) == set(jprof.__all__)


def test_print_mem_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.print_mem("x") == {}
    assert capsys.readouterr().out == ""


def test_trace_writes_a_trace_file(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        y = (torch.randn(64, 64) @ torch.randn(64, 64)).relu().sum()
    assert float(y) >= 0 and prof is not None
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_step_timer_sets_seconds(capsys):
    with tprof.step_timer("work") as out:
        torch.randn(256, 256).sum()
    assert out["seconds"] > 0 and "[time] work:" in capsys.readouterr().out


def test_nan_debugging_raises_in_the_backward():
    x = torch.zeros(3, requires_grad=True)
    tprof.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        y = x.sqrt() * 0.0                      # the forward is finite
        with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
            y.sum().backward()
        z = torch.log(torch.tensor(-1.0))       # a NaN in the forward alone passes
        assert torch.isnan(z)
    finally:
        tprof.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()

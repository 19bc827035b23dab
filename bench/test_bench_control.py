"""The correctness check at a size a CPU holds: the program as it stands
passes, the lower-precision controls that the cell's limits separate
fail, and so does a run whose timed path is broken underneath (half of
each batch left out, one answer altered where it is produced).  The runs
skip the harness's look for a chip and drive the rest of a run on the
CPU."""

import time

import pytest
import torch

from bench.control import control
from bench.harness import cell, manifest
from repro_torch.api.model import CompiledModel

SMALL = {"batch": 3, "test_set": 6}
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
# the controls each cell's limits separate (PERF.md: bfloat16 functional
# blocks read within 2x of sound runs on vit_tiny, and are not held)
CONTROLS = [(c, "w7a7") for c in CELLS] + [("resnet18.eval_b1024", "bf16")]


def _run(workload, **kw):
    result, numbers = cell.run(workload, 2**31 + 3, 0.3, False,
                               t0=time.perf_counter(),
                               device=torch.device("cpu"),
                               mix_overrides=SMALL, **kw)
    return result, numbers


def _half_left_out(run):
    def broken(self, x, **kw):
        out = run(self, x, **kw).clone()
        h = (out.shape[0] + 1) // 2
        out[h:] = out[:h].mean(dim=0)
        return out
    return broken


def _answer_altered(run):
    def broken(self, x, **kw):
        out = run(self, x, **kw).clone()
        top, last = out[0].argmax(), out[0].argmin()
        out[0, top], out[0, last] = out[0, last].item(), out[0, top].item()
        return out
    return broken


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, _ = _run(workload)
    assert result["correct"] and result["failed"] == 0
    assert set(result["compared"]) == set(manifest.limits(workload))


@pytest.mark.parametrize("workload,kind", CONTROLS)
def test_lower_precision_control_is_not_correct(workload, kind):
    result, numbers = _run(workload, **control(kind))
    assert not result["correct"]
    assert any(v["value"] > v["limit"]
               for v in result["compared"].values())


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    monkeypatch.setattr(CompiledModel, "run", fault(CompiledModel.run))
    result, _ = _run(workload)
    assert not result["correct"]


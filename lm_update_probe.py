"""pytest plugin: log what the small LM card-vs-CPU training test reads.

    PYTHONPATH=. python3 -m pytest -p lm_update_probe -m cuda \\
        tests/test_torch_cuda.py

``tests/test_torch_cuda.py::test_small_lm_trains_on_card_like_cpu``
holds each parameter's update after three f32 steps on the card against
the CPU's, row by row (``_row_rel_err``).  This plugin wraps that check
while the test runs and appends one JSON line per run of the test to
``chiprun_out/lm_update_probe.jsonl`` (``LM_UPDATE_TAG`` names the run):
the outcome, and the three worst checks with their error, both sides'
norms, the largest difference and, for a tensor of at most 64 values,
both sides' values.  The test itself is left as it is.
"""
import json
import os
from pathlib import Path

TARGET = "test_small_lm_trains_on_card_like_cpu"
LOG = Path(__file__).resolve().parent / "chiprun_out" / "lm_update_probe.jsonl"
_checks = []
_active = {"on": False}


def _values(t):
    return t.flatten().tolist() if t.numel() <= 64 else None


def pytest_collection_finish(session):
    for item in session.items:
        if item.name != TARGET:
            continue
        module = item.module
        check = module._row_rel_err

        def logged(got, ref, scale=None):
            err = check(got, ref, scale)
            if _active["on"]:
                got32, ref32 = got.float(), ref.float()
                _checks.append(dict(
                    err=err, shape=list(got.shape),
                    got_norm=float(got32.norm()), ref_norm=float(ref32.norm()),
                    diff_max=float((got32 - ref32).abs().max()),
                    got=_values(got32), ref=_values(ref32)))
            return err

        module._row_rel_err = logged


def pytest_runtest_call(item):
    _active["on"] = item.name == TARGET


def pytest_runtest_logreport(report):
    if report.when != "call" or not report.nodeid.endswith(TARGET):
        return
    _checks.sort(key=lambda c: -c["err"])
    LOG.parent.mkdir(exist_ok=True)
    with LOG.open("a") as f:
        f.write(json.dumps(dict(tag=os.environ.get("LM_UPDATE_TAG"),
                                outcome=report.outcome, checks=len(_checks),
                                worst=_checks[:3])) + "\n")
    _checks.clear()

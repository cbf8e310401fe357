"""What a run loads: no JAX and not the JAX package (top-level names
compared whole: `aic_tpu_torch` is not `aic_tpu`), and a reference that
loads nothing of the program."""

import json
import subprocess
import sys

from voxbench import harness


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=harness.ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import voxbench.reference.light, voxbench.reference.world")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"aic_tpu_torch", "aic_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax(tiny_world):
    """A whole rehearsal of a cell, in its own process, as the benchmark's
    command runs it; it checks `sys.modules` itself after the window."""
    cmd = [sys.executable, "voxbench/run.py", "--workload", "atrium.relight", "--seed", "5",
           "--seconds", "1", "--rehearse-cpu", "--override", "sample_events=1",
           "--override", 'mix={"single": 1.0, "slab": 0.0, "wall": 0.0}']
    cmd += [a for k in ("world", "lamp_blocks", "opaque_blocks")
            for a in ("--override", f"{k}={json.dumps(tiny_world[k])}")]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "forbidden modules" not in out.stderr
    mods = _modules("import voxbench.harness as h, voxbench.run\n"
                    "h.driver_module('relight')\n"
                    "import aic_tpu_torch.io.save, aic_tpu_torch.light.update, aic_tpu_torch.universe.transaction")
    assert not {m.split(".")[0] for m in mods} & set(harness.FORBIDDEN_MODULES)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "aic_tpu_torch_like", sys)
    assert "aic_tpu_torch_like" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "aic_tpu.math", sys)
    assert "aic_tpu.math" in harness.forbidden_loaded()


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "voxbench/run.py", "--workload", "atrium.relight", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode == 2 and out.stdout.strip() == ""

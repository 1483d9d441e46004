"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU.

Each example's ``main(argv)`` runs at its smallest size with ``--device
cpu`` in a fresh interpreter, returns 0 (its own functional check passed)
and leaves neither ``jax`` nor the JAX package (``repro``) imported: the
examples use only ``repro_torch``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SMALL_SERVE = ["--device", "cpu", "--img", "32", "--frames", "2", "--streams", "2"]

CASES = {
    "quickstart": ("torch_quickstart.py", ["--device", "cpu", "--steps", "2", "--img", "32", "--base", "8",
                                           "--batch", "2"]),
    "mri_pipeline": ("torch_mri_pipeline.py", ["--device", "cpu", "--train-steps", "1", "--img", "32",
                                               "--frames", "2"]),
    "multi_stream_recon": ("torch_multi_stream_recon.py", ["--device", "cpu", "--img", "32"]),
    "multi_stream_serve": ("torch_multi_stream_serve.py", SMALL_SERVE),
    "multi_stream_serve_replicas": ("torch_multi_stream_serve.py",
                                    SMALL_SERVE + ["--replicas", "2", "--open-loop", "--duration", "0.3"]),
    "multi_stream_serve_workers": ("torch_multi_stream_serve.py", SMALL_SERVE + ["--workers", "2"]),
    "lm_train": ("torch_lm_train.py", ["--device", "cpu", "--steps", "30", "--seq", "32", "--batch", "4",
                                       "--log-every", "10"]),
}

RUN = """
import runpy, sys
mod = runpy.run_path(sys.argv[1], run_name="torch_example")
rc = mod["main"](sys.argv[2:])
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("example rc", rc)
sys.exit(rc)
"""


@pytest.mark.parametrize("case", list(CASES))
def test_torch_example_runs_on_the_cpu_without_jax(case):
    script, argv = CASES[case]
    r = subprocess.run(
        [sys.executable, "-c", RUN, str(ROOT / "examples" / script), *argv],
        capture_output=True, text=True, timeout=300,
        # one intra-op thread: as fast at these sizes, and it leaves the
        # cores to the files the suite runs beside this one
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"),
    )
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "example rc 0" in r.stdout
    assert ": OK" in r.stdout  # the example's own functional check line

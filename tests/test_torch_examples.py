"""The port's four examples run on the CPU at small arguments.

Each runs as a user runs it, ``python examples/torch_*.py --device cpu``,
in a subprocess, and must exit 0: the engine examples hold every product
against its oracle themselves (``HOLD``), the training example asserts
that the loss falls and that a run resumed from a checkpoint retraces
the uninterrupted one.  The quickstart runs once more on a 2x4 grid of
eight gloo processes (``--ranks 8``), where the JAX version emulates a
2x4 mesh.
"""
import os
import subprocess
import sys

import pytest

from conftest import REPO, SRC

#: name -> (script, arguments after --device cpu, a line its output holds)
CASES = {
    "quickstart": ("torch_quickstart.py", [], "allgather   k_blocks=  8"),
    "quickstart-2x4": ("torch_quickstart.py", ["--ranks", "8"],
                       "multiple-issue limit I(P_row=2, P_col=4, K=8) = 2"),
    "blocksparse": ("torch_blocksparse_contraction.py", [],
                    "chained contraction (A.B).C"),
    "serve": ("torch_serve_batch.py", ["--batch", "2", "--prompt-len", "16",
                                       "--gen", "4"],
              "generated shape: (2, 4)"),
    "train": ("torch_train_e2e.py", ["--steps", "12", "--ckpt-every", "5",
                                     "--global-batch", "4", "--seq", "32"],
              "resumed from step 10: 2 steps retrace"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_example_runs_on_the_cpu(case, tmp_path):
    script, args, line = CASES[case]
    if case == "train":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script),
         "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert line in proc.stdout, out[-4000:]


def test_examples_import_only_the_port():
    """The examples import ``repro_torch``, never ``jax`` or ``repro``."""
    for name in {script for script, _, _ in CASES.values()}:
        with open(os.path.join(REPO, "examples", name)) as f:
            text = f.read()
        for banned in ("import jax", "from jax", "import repro\n",
                       "from repro.", "from repro import"):
            assert banned not in text, (name, banned)

"""``python -m repro_torch.launch.train`` on the CPU: the port's versions
of the reference's training tests (``tests/test_system.py`` and
``tests/test_train.py::test_failure_injection_and_lossless_resume``).

The loss falls over 40 steps of llama3.2-1b (SMOKE) on the synthetic
stream; ``--matmul-strategy summa`` (every FFN projection and its two
backward products on the paper's engine, on the 1x1 grid) follows the
xla route's losses within rtol 2e-2; the hybrid recurrentgemma-9b trains
to finite losses; a run killed at step 16 (exit 42, after its
checkpoint) and resumed ends within 1e-4 of the uninterrupted run.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.train import main as train_main


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_training_reduces_loss():
    losses = train_main([
        "--device", "cpu", "--arch", "llama3.2-1b", "--smoke", "--steps",
        "40", "--global-batch", "4", "--seq", "64", "--log-every", "100",
    ])
    assert len(losses) == 40
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_summa_strategy_training_matches_xla():
    common = [
        "--device", "cpu", "--arch", "llama3.2-1b", "--smoke", "--steps",
        "6", "--global-batch", "2", "--seq", "32", "--log-every", "100",
    ]
    l_xla = train_main(common + ["--matmul-strategy", "xla"])
    l_summa = train_main(common + ["--matmul-strategy", "summa"])
    np.testing.assert_allclose(l_xla, l_summa, rtol=2e-2)


def test_hybrid_arch_end_to_end():
    losses = train_main([
        "--device", "cpu", "--arch", "recurrentgemma-9b", "--smoke",
        "--steps", "10", "--global-batch", "2", "--seq", "32",
        "--log-every", "100", "--optimizer", "adafactor",
        "--microbatches", "2",
    ])
    assert np.isfinite(losses).all()


def test_failure_injection_and_lossless_resume(tmp_path, capsys):
    """Kill at step 16, resume, final loss equals the uninterrupted run."""
    common = [
        "--device", "cpu", "--arch", "llama3.2-1b", "--smoke", "--steps",
        "24", "--global-batch", "2", "--seq", "32", "--ckpt-every", "8",
        "--log-every", "50",
    ]
    ref_losses = train_main(common + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(SystemExit) as e:
        train_main(common + ["--ckpt-dir", str(tmp_path / "ft"),
                             "--fail-at-step", "16"])
    assert e.value.code == 42
    resumed = train_main(common + ["--ckpt-dir", str(tmp_path / "ft"),
                                   "--resume"])
    out = capsys.readouterr().out
    assert "[failure-sim] dying at step 16" in out
    assert "[resume] restored step 16" in out
    assert len(resumed) == 8
    assert abs(resumed[-1] - ref_losses[-1]) < 1e-4

"""The train step of the recurrent families against the JAX package.

As ``tests/test_torch_train.py`` holds the dense, MoE and frontend
families: one step of recurrentgemma-9b (RG-LRU units and a tail of two
RG-LRU blocks) and of xlstm-1.3b (mLSTM and sLSTM), SMOKE, fp32, from the
reference's state on the same batch: the metrics within rtol 1e-4, the
new params and every optimizer slot within 1e-4 of each leaf's largest
value for recurrentgemma-9b.

xlstm-1.3b's state is held at 1e-2 of each leaf's largest value: its
fp32 gradient is ill-conditioned at this init (the first mLSTM block's
gradients reach a norm of 3e3 through the normaliser ``max(|Σ sw|,
e^-m)``): moving every parameter by one fp32 ulp moves the reference's
own gradient by more than 1e-3 of its largest element
(``tests/test_torch_train_conditioning.py``), so two packages that sum
in different orders cannot agree to 1e-4.  Its
metrics keep 1e-4.
"""
import pytest
import torch

from test_torch_train import _hold, _step_both


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch,tol", [("recurrentgemma-9b", 1e-4),
                                      ("xlstm-1.3b", 1e-2)])
def test_recurrent_train_step_matches_reference_fp32(arch, tol):
    metrics, rmetrics, got, want = _step_both(arch)
    for k in rmetrics:
        assert float(metrics[k]) == pytest.approx(float(rmetrics[k]),
                                                  rel=1e-4, abs=1e-6), k
    assert got["step"] == want["step"] == 1
    _hold(got, want, tol)


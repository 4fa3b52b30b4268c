"""The port's bf16 training step against the JAX package's (the setting of
``tests/test_torch_port_train_step.py`` with ``bf16_run``): parameters
stored in float32 and cast to bf16 at the forward boundary on both sides.

Tolerances (bf16 rounds at other places in the two frameworks): losses to
5e-3 relative; gradient norms, whole and per module, to 5e-2 relative;
updated parameters to 1e-6 absolute in all but 3% of the elements and to
2 lr in those (a first Adam step normalizes each gradient, so rounding
decides the sign of those near zero).
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import pytest
import torch

from test_torch_port_train_step import (_close_metrics, _close_params, port_pair,
                                        run_jax_step)


@pytest.fixture(scope="module")
def bf16_step():
    return run_jax_step(bf16=True)


def test_bf16_step_matches_jax(bf16_step):
    metrics, ref_g, ref_d, ids = bf16_step
    _, step, tb, _, _ = port_pair(bf16=True)
    got = step(tb, ids_slice=torch.from_numpy(ids))
    losses = {k: v for k, v in metrics.items() if k.startswith(("loss", "mel"))}
    norms = {k: v for k, v in metrics.items() if k not in losses}
    _close_metrics(losses, got, 5e-3)
    _close_metrics(norms, got, 5e-2)
    _close_params(ref_g, step.model_g, frac=3e-2)
    _close_params(ref_d, step.model_d, frac=3e-2)


def test_bf16_step_keeps_float32_parameters_and_metrics(bf16_step):
    """The policy: the parameters and the optimizer's moments stay float32,
    the metrics are float32 scalars."""
    _, step, tb, _, _ = port_pair(bf16=True)
    got = step(tb, ids_slice=torch.from_numpy(bf16_step[3]))
    for module in (step.model_g, step.model_d):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(t.dtype == torch.float32 for t in step.opt_g.mu + step.opt_g.nu)
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in got.values())

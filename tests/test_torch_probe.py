"""Kernel K8's entry point and the port's cold-start probe
(vgtpu_torch/utils/cold_probe.py) against tools/probe_cold_tax.py's Pallas
probe kernel `k` (x * 2 + 1), run in interpret mode: exact, since x * 2 is
exact and the add rounds once on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from vgtpu_torch.utils import cold_probe  # noqa: E402


def _pallas_probe(x):
    """tools/probe_cold_tax.py's PALLAS probe kernel, in interpret mode."""
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          interpret=True)(x)


def test_probe_affine_matches_pallas_probe():
    x = np.random.default_rng(5).normal(0, 1e3, cold_probe.SHAPE).astype(np.float32)
    ref = np.asarray(_pallas_probe(jnp.asarray(x)))
    got = cold_probe.probe_affine(torch.from_numpy(x))
    assert got.shape == ref.shape == cold_probe.SHAPE
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k8_wrapper_refuses_cpu_tensors_and_other_devices():
    """The CUDA wrapper never runs the plain twin: a CPU tensor raises
    before any build or launch; the dispatcher refuses devices other than
    CUDA and the CPU."""
    from vgtpu_torch.ops.probe_cuda import K8, probe_affine_cuda

    before = K8.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_affine_cuda(torch.zeros(cold_probe.SHAPE))
    assert K8.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cold_probe.probe_affine(torch.zeros(cold_probe.SHAPE, device="meta"))


@pytest.mark.parametrize("name", sorted(cold_probe.PHASES))
def test_cold_probe_phase_programs_compile(name):
    code = cold_probe.phase_code(name)
    compile(code, f"<cold probe {name}>", "exec")
    assert 'sys.modules["jax"] = None' in code


def test_cold_probe_needs_a_card(capsys):
    """Without a CUDA device main() prints no result and returns 1, and a
    phase run in its own process fails instead of measuring the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cold_probe.main() == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="phase torch failed"):
        cold_probe.run_phase("torch")

"""repro_torch on a CUDA card: the kernels against their plain versions,
and the default device. These tests skip without a card; on the GPU
machine, which has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor repro."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks on the GPU")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the same CUDA tensors,
    bit for bit with NaNs made canonical, over chip_smoke.py's case list."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    errs, records = chip_smoke.check_kernels("cuda", 50)
    assert all(r["ok"] for r in records) and max(errs.values()) == 0.0


@pytest.mark.cuda
def test_default_device_runs_the_kernels():
    """Simulation without a device runs on the card through K2, one launch
    per chunk, and never through the plain version."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.pde import HeatConfig, Simulation

    sim = Simulation("heat1d", HeatConfig(nx=128), PRESETS["r2f2_16"])
    launches, plain = HEAT1D_SWEEP.launches, HEAT1D_SWEEP.plain_calls
    res = sim.run(400, execution="fused")
    assert res.state.is_cuda
    assert (HEAT1D_SWEEP.launches - launches, HEAT1D_SWEEP.plain_calls - plain) == (8, 0)
    ref = sim.run(400)
    assert torch.equal(res.state.view(torch.int32), ref.state.view(torch.int32))

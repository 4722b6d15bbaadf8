"""The port's examples (examples/torch_*.py) run end to end on the CPU at a
few steps, each through its ``main``: the quickstart's five parts, the heat
and shallow-water ladders, the zoo with --profile and --ensemble, and the
service burst with --trace."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_quickstart(capsys):
    rels = example("torch_quickstart").main(["--device", "cpu", "--steps", "20"])
    assert set(rels) == {"e5m10", "r2f2_16"} and rels["r2f2_16"] < 0.05
    assert "done." in capsys.readouterr().out


@pytest.mark.parametrize("execution", ("reference", "megakernel"))
def test_heat_equation(execution, capsys):
    rels = example("torch_heat_equation").main(["--device", "cpu", "--steps", "30", "--execution", execution])
    assert rels["r2f2_16"] < 0.05 and "matches f32" in capsys.readouterr().out


def test_swe_simulation(capsys):
    verdicts = example("torch_swe_simulation").main(["--device", "cpu", "--steps", "6", "--nx", "32",
                                                      "--execution", "fused"])
    assert verdicts["r2f2_16"] > 0.98 and "field correlation" in capsys.readouterr().out


def test_pde_zoo_with_profile_and_ensemble(capsys):
    out = example("torch_pde_zoo").main(["--device", "cpu", "--steps", "8", "--steppers", "heat1d,burgers1d",
                                         "--execution", "megakernel", "--profile", "--ensemble", "3"])
    assert set(out) == {"heat1d", "burgers1d"} and len(out["heat1d"]["ensemble"]) == 3
    text = capsys.readouterr().out
    assert "autotuned splits" in text and "ensemble[3]" in text


def test_pde_service_with_trace(tmp_path, capsys):
    out = example("torch_pde_service").main(["--device", "cpu", "--steps", "16", "--workloads", "heat2d,burgers1d",
                                             "--trace", str(tmp_path / "obs")])
    assert out["done"] and out["summary"]["completed"] == 8
    assert all(rel < 0.1 for rel in out["rels"].values()) and len(out["rels"]) == 4
    text = capsys.readouterr().out
    assert "[tune] heat2d" in text and "occupancy" in text and "trace.json" in text

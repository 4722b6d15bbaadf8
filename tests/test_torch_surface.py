"""Package surfaces: every name a repro package exports (its ``__all__``,
or its public names where it has none) imports from the same package of
repro_torch, apart from the names still waiting for their ROADMAP item.
PENDING can only shrink: a name in it that the port exports fails."""

import importlib

import pytest

PACKAGES = ("core", "pde", "precision", "pack", "alu", "serve", "profile", "models", "configs", "dist", "ckpt", "obs",
            "service", "obs.health", "obs.shadow", "obs.flightrec", "obs.server")

#: (package, name) -> the ROADMAP.md item it waits for
PENDING = {
    ("models", "lm_loss"): "queue 1, the LM stack: model.py::lm_loss",
}


def exported(mod):
    names = getattr(mod, "__all__", None)
    return list(names) if names is not None else [n for n in vars(mod) if not n.startswith("_")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_reference_name_imports_from_the_port(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = exported(ref)
    assert names
    missing = [n for n in names if not hasattr(port, n) and (pkg, n) not in PENDING]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    ported = [n for (p, n) in PENDING if p == pkg and hasattr(port, n)]
    assert not ported, f"repro_torch.{pkg} exports {ported}: take them out of PENDING"
    for n in getattr(port, "__all__", ()):
        assert hasattr(port, n), f"repro_torch.{pkg}.__all__ names {n}, which it lacks"

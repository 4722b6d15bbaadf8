"""repro_torch.dist.sharding against repro.dist.sharding: the rule table,
every logical name resolved on the same meshes (a one-device mesh under
each axis layout), unknown names refused, and constrain's contract:
the identity outside axis_rules, its rank and name checks inside, passive
on one device."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.dist import sharding as jsh
from repro_torch.dist import DEFAULT_RULES, LocalMesh, active_mesh, axis_rules, constrain, logical_spec

LAYOUTS = (("data",), ("data", "model"), ("pod", "data", "model"), ("model",))


def test_rules_are_repros():
    assert DEFAULT_RULES == jsh.DEFAULT_RULES


@pytest.mark.parametrize("axes", LAYOUTS)
@pytest.mark.parametrize("name", [None, *sorted(jsh.DEFAULT_RULES)])
def test_every_logical_name_resolves_as_in_repro(name, axes):
    """Each logical name (and None) resolves on a mesh of each layout to the
    mesh axes repro resolves it to: axes the mesh lacks dropped, empties
    None."""
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes)
    assert logical_spec(name, mesh=LocalMesh(axes)) == jsh.logical_spec(name, mesh=jmesh)


def test_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        logical_spec("tokens", mesh=LocalMesh())
    with axis_rules(LocalMesh()), pytest.raises(KeyError):
        constrain(torch.zeros(2, 3), "batch", "tokens")


def test_constrain_is_passive_on_one_device():
    """Outside a context constrain is the identity whatever it is given;
    inside, the wrong count of names raises ValueError and a one-device
    mesh gives the same tensor back; contexts nest, the innermost wins."""
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "batch") is x and active_mesh() is None
    outer, inner = LocalMesh(("data",)), LocalMesh(("pod", "data", "model"))
    with axis_rules(outer) as m:
        assert m is outer and active_mesh() is outer
        with pytest.raises(ValueError, match="2 axis names for rank-1"):
            constrain(torch.zeros(4), "batch", None)
        with axis_rules(inner):
            assert active_mesh() is inner
            assert constrain(x, "batch", "mlp") is x
        assert active_mesh() is outer
    assert active_mesh() is None


def test_constrain_refuses_a_split_across_devices():
    """A mesh of several devices whose batch axes divide the dim would split
    it: the port places tensors on one device, so it raises; a dim they do
    not divide stays unconstrained, as in repro."""

    class Mesh4:
        axis_names, shape = ("data",), {"data": 4}

    with axis_rules(Mesh4()):
        assert constrain(torch.zeros(3, 5), "batch", None).shape == (3, 5)
        with pytest.raises(NotImplementedError, match="one device"):
            constrain(torch.zeros(8, 5), "batch", None)

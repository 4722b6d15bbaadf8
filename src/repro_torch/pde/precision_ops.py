"""The PDE elementwise ops over ``repro_torch.precision``, by their old names.

  pmul(a, b, cfg)  == precision.multiply: the policy's multiplier
  pstore(x, cfg)   == precision.store: the low-bitwidth write-back
  pdiv(a, b, cfg)  == precision.divide: the flexible divider under rr modes,
                      format-rounded for fixed units, f32 for the reference
  padd(a, b, cfg)  == precision.add: the flexible adder

``pmul``/``pdiv``/``padd`` also take ``tracker``/``site`` and then return
``(out, tracker)``.
"""

from __future__ import annotations

__all__ = ["pmul", "pstore", "pdiv", "padd"]


def pmul(a, b, cfg, *, tracker=None, site=None):
    from repro_torch.precision import multiply

    return multiply(a, b, cfg, tracker=tracker, site=site)


def pstore(x, cfg):
    from repro_torch.precision import store

    return store(x, cfg)


def pdiv(a, b, cfg, *, tracker=None, site=None):
    from repro_torch.precision import divide

    return divide(a, b, cfg, tracker=tracker, site=site)


def padd(a, b, cfg, *, tracker=None, site=None):
    from repro_torch.precision import add

    return add(a, b, cfg, tracker=tracker, site=site)

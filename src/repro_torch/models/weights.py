"""Weights carried across from the JAX package's parameter layout.

The JAX package's tree (``repro.models.model.init_params``) is
``{"embed", "final_norm", "prelude", "main", "trailing"}`` (plus
``"encoder"``/``"enc_norm"`` with an encoder and ``"lm_head"`` without
tied embeddings), where ``prelude``/``trailing`` are tuples over units of
NamedTuples and ``main``/``encoder`` tuples over units of NamedTuples whose
leaves are stacked on a leading [n_super] axis.

``numpy_params`` draws such a tree with numpy (each unit a dict under the
NamedTuple's field names), so that the tests, the JAX reference writer and
``chip_smoke.py`` can give both packages the same weights without JAX on
the card; ``from_jax_params`` turns the JAX package's tree, or that one,
into the port's ``model.Params``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import model, transformer

NORM_STD = 0.1  # norm scales are drawn too, so that a wrong `1 + scale` shows


def _draw(rng, shape, fan_in) -> np.ndarray:
    """float32: fan_in None -> NORM_STD * N(0, 1); else N(0, 1) clipped at
    +-2 and scaled by fan_in ** -0.5 (``common.dense_init``'s law but for
    the clip, which keeps the draw one pass)."""
    x = rng.standard_normal(shape, dtype=np.float32)
    if fan_in is None:
        x *= NORM_STD
    else:
        np.clip(x, -2.0, 2.0, out=x)
        x *= np.float32((1.0 / max(fan_in, 1)) ** 0.5)
    return x


def numpy_params(cfg, seed: int = 0) -> dict:
    """A parameter tree in the JAX package's layout, drawn with numpy from
    ``seed``; each unit is a dict of float32 arrays by field name."""
    rng = np.random.default_rng(seed)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    D = cfg.d_model

    def unit(u, lead=()):
        return {name: _draw(rng, lead + shape, fan_in)
                for name, (shape, fan_in) in transformer.unit_shapes(cfg, u).items()}

    def stack(units, n):
        return tuple(unit(u, (n,)) for u in units) if n else tuple(() for _ in units)

    tree = {"embed": _draw(rng, (cfg.vocab, D), D), "final_norm": _draw(rng, (D,), None),
            "prelude": tuple(unit(u) for u in prelude), "main": stack(sb, n_super),
            "trailing": tuple(unit(u) for u in trailing)}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        tree["encoder"] = stack(eu, en)
        tree["enc_norm"] = _draw(rng, (D,), None)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _draw(rng, (D, cfg.vocab), D)
    return tree


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _fields(unit) -> dict:
    return unit._asdict() if hasattr(unit, "_asdict") else dict(unit)


def from_jax_params(tree, cfg, device=None) -> model.Params:
    """The port's params from a tree in the JAX package's layout (numpy
    arrays, or anything ``np.asarray`` takes), on ``device`` (``None``
    means ``"cuda"``); matrices cast to ``cfg.dtype``, norms float32."""
    dev = resolve_device(device)
    dt = model._dtype(cfg)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)

    def unit(u, fields, i=None):
        return transformer.unit_params(
            cfg, u, {k: _tensor(v if i is None else np.asarray(v)[i])
                     for k, v in _fields(fields).items()}, dt, dev)

    def units(us, leaves):
        return nn.ModuleList(unit(u, f) for u, f in zip(us, leaves))

    def stack(us, n, leaves):
        return nn.ModuleList(nn.ModuleList(unit(u, f, i) for u, f in zip(us, leaves))
                             for i in range(n))

    def matrix(key):
        return _tensor(tree[key]).to(device=dev, dtype=dt)

    kw = {}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        kw["encoder"] = stack(eu, en, tree["encoder"])
        kw["enc_norm"] = _tensor(tree["enc_norm"]).to(dev)
    if not cfg.tie_embeddings:
        kw["lm_head"] = matrix("lm_head")
    return model.Params(cfg, matrix("embed"), _tensor(tree["final_norm"]).to(dev),
                        units(prelude, tree["prelude"]), stack(sb, n_super, tree["main"]),
                        units(trailing, tree["trailing"]), **kw)

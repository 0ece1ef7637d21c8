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
into the port's ``model.Params``, and ``to_numpy_params`` turns those back.
``leaves`` names each of the port's tensors by the JAX package's leaf
name, which the optimizer's moments and the checkpoints use.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import common, model, transformer

NORM_STD = 0.1  # norm scales are drawn too, so that a wrong `1 + scale` shows


def _draw(rng, shape, f: common.Field) -> np.ndarray:
    """A float32 draw of ``shape`` (the field's, behind any leading stack
    axes) by the field's init kind:

    - "dense": N(0, 1) clipped at +-2 and scaled by fan_in ** -0.5
      (``common.dense_init``'s law but for the clip, which keeps the draw
      one pass);
    - "zeros" (norm scales, the sLSTM bias): NORM_STD * N(0, 1);
    - "ones" (the group norms' gn): 1 + NORM_STD * N(0, 1), so that
      ``gn - 1`` is a small scale as the JAX init's ones make it;
    - "lam" (the RG-LRU's Lambda): -logit(linspace(0.9, 0.999, R)) plus
      NORM_STD * N(0, 1).  The JAX package decays by a = exp(-8 rg
      softplus(lam)) (softplus of +lam, ``recurrent.py:298``): at its own
      init, logit(linspace), a is 1e-4 to 1e-12 at rg = 1/2 and a test
      would never see the carried state; the negated logit gives a of
      0.66 to 0.996 there, the range the JAX init's comment aims for.
    """
    x = rng.standard_normal(shape, dtype=np.float32)
    if f.init == "dense":
        np.clip(x, -2.0, 2.0, out=x)
        x *= np.float32((1.0 / max(f.fan_in, 1)) ** 0.5)
        return x
    x *= NORM_STD
    if f.init == "ones":
        x += np.float32(1.0)
    elif f.init == "lam":
        a = np.linspace(0.9, 0.999, shape[-1], dtype=np.float32)
        x -= np.log(a / (1 - a))
    elif f.init != "zeros":
        raise ValueError(f.init)
    return x


def numpy_params(cfg, seed: int = 0) -> dict:
    """A parameter tree in the JAX package's layout, drawn with numpy from
    ``seed``; each unit is a dict of float32 arrays by field name."""
    rng = np.random.default_rng(seed)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    D = cfg.d_model
    norm = common.norm((D,))

    def unit(u, lead=()):
        return {name: _draw(rng, lead + f.shape, f)
                for name, f in transformer.unit_shapes(cfg, u).items()}

    def stack(units, n):
        return tuple(unit(u, (n,)) for u in units) if n else tuple(() for _ in units)

    tree = {"embed": _draw(rng, (cfg.vocab, D), common.dense((cfg.vocab, D), D)),
            "final_norm": _draw(rng, (D,), norm),
            "prelude": tuple(unit(u) for u in prelude), "main": stack(sb, n_super),
            "trailing": tuple(unit(u) for u in trailing)}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        tree["encoder"] = stack(eu, en)
        tree["enc_norm"] = _draw(rng, (D,), norm)
    if not cfg.tie_embeddings:
        tree["lm_head"] = _draw(rng, (D, cfg.vocab), common.dense((D, cfg.vocab), D))
    return tree


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _fields(unit) -> dict:
    return unit._asdict() if hasattr(unit, "_asdict") else dict(unit)


def from_jax_params(tree, cfg, device=None, trainable: bool = False) -> model.Params:
    """The port's params from a tree in the JAX package's layout (numpy
    arrays, or anything ``np.asarray`` takes), on ``device`` (``None``
    means ``"cuda"``); each field frozen in the dtype it is read in
    (``common.Field.f32``: float32, or ``cfg.dtype``), or with
    ``trainable`` a float32 master that takes a gradient."""
    dev = resolve_device(device)
    dt = model._dtype(cfg)
    master = common.master_dtype(cfg, trainable)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)

    def unit(u, fields, i=None):
        return transformer.unit_params(
            cfg, u, {k: _tensor(v if i is None else np.asarray(v)[i])
                     for k, v in _fields(fields).items()}, dt, dev, master)

    def units(us, leaves):
        return nn.ModuleList(unit(u, f) for u, f in zip(us, leaves))

    def stack(us, n, leaves):
        return nn.ModuleList(nn.ModuleList(unit(u, f, i) for u, f in zip(us, leaves))
                             for i in range(n))

    def matrix(key):  # Params casts it to its held dtype
        return _tensor(tree[key]).to(dev)

    kw = {}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        kw["encoder"] = stack(eu, en, tree["encoder"])
        kw["enc_norm"] = _tensor(tree["enc_norm"]).to(dev)
    if not cfg.tie_embeddings:
        kw["lm_head"] = matrix("lm_head")
    return model.Params(cfg, matrix("embed"), _tensor(tree["final_norm"]).to(dev),
                        units(prelude, tree["prelude"]), stack(sb, n_super, tree["main"]),
                        units(trailing, tree["trailing"]), master=master, **kw)


_TOP = ("embed", "final_norm", "enc_norm", "lm_head")


def slots(params: model.Params):
    """(name, superblock, module, attribute) of every parameter, in
    ``leaves``' order: where ``module._parameters[attribute]`` holds it."""
    for key in _TOP:
        if params._parameters.get(key) is not None:
            yield key, None, params, key
    for group in ("prelude", "trailing"):
        for j, unit in enumerate(getattr(params, group)):
            for f in unit.FIELDS:
                yield f"{group}.{j}.{f}", None, unit, f
    for group in ("main", "encoder"):
        for i, sb in enumerate(getattr(params, group) or ()):
            for j, unit in enumerate(sb):
                for f in unit.FIELDS:
                    yield f"{group}.{j}.{f}", i, unit, f


def leaves(params: model.Params):
    """(name, superblock, tensor) of every parameter: its leaf name in the
    JAX package's tree as ``repro.train.checkpoint._leaf_id`` writes it
    ("embed", "prelude.0.ln", "main.1.wq"), the superblock it stands at on
    the stacked [n_super] axis of a "main" or "encoder" leaf (else
    ``None``), and the port's tensor (the master itself, not its cast)."""
    for name, i, module, attr in slots(params):
        yield name, i, module._parameters[attr]


def stacked(named) -> dict:
    """name -> array from ``leaves``-like (name, superblock, array)
    triples: a stacked leaf's superblocks stacked on a leading axis."""
    out, parts = {}, {}
    for name, i, a in named:
        if i is None:
            out[name] = a
        else:
            parts.setdefault(name, []).append(a)
    for name, arrays in parts.items():
        out[name] = (np.stack if isinstance(arrays[0], np.ndarray) else torch.stack)(arrays)
    return out


def to_numpy_params(params: model.Params, cfg) -> dict:
    """The inverse of ``from_jax_params``: a tree in the JAX package's
    layout (``numpy_params``': units as dicts by field name, "main" and
    "encoder" stacked on [n_super]) of float32 numpy arrays."""
    return layout(stacked((name, i, t.detach().to(device="cpu", dtype=torch.float32).numpy())
                          for name, i, t in leaves(params)), cfg)


def layout(flat: dict, cfg) -> dict:
    """The JAX package's tree of ``cfg`` from leaf name -> array (a
    "main" or "encoder" leaf stacked on [n_super])."""
    prelude, sb, n_super, trailing = transformer.block_program(cfg)

    def units(group, us, n=None):
        if n == 0:
            return tuple(() for _ in us)
        return tuple({f: flat[f"{group}.{j}.{f}"] for f in transformer.unit_shapes(cfg, u)}
                     for j, u in enumerate(us))

    tree = {"embed": flat["embed"], "final_norm": flat["final_norm"],
            "prelude": units("prelude", prelude), "main": units("main", sb, n_super),
            "trailing": units("trailing", trailing)}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        tree["encoder"] = units("encoder", eu, en)
        tree["enc_norm"] = flat["enc_norm"]
    if not cfg.tie_embeddings:
        tree["lm_head"] = flat["lm_head"]
    return tree

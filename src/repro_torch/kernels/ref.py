"""The plain PyTorch versions of the kernels under the JAX package's names
and signatures (``repro.kernels.ref``): one simulation, link vectors of
``n_links`` without the sentinel slot.  Each adds the port's batch
dimension and sentinel slot and calls the plain version beside its
kernel, so a test can feed both packages the same arrays."""
from __future__ import annotations

import torch

from repro_torch.kernels import cascade_tiered as ct, linkload as ll
from repro_torch.kernels.flash_attention import flash_attention_torch as flash_attention_ref

__all__ = ["flash_attention_ref", "linkload_ref", "linkload_cascade_ref",
           "linkload_cascade_tiered_ref"]


def _with_sentinel(vec: torch.Tensor, value: float) -> torch.Tensor:
    return torch.cat([vec, torch.full((1,), value, dtype=vec.dtype, device=vec.device)])


def _sentinel_layout(queue, capacity, queue_mask):
    """[n_links] vectors -> the batched sentinel layout of the kernels."""
    return (_with_sentinel(queue, 0.0)[None], _with_sentinel(capacity, 1e30),
            _with_sentinel(queue_mask, 0.0))


def linkload_ref(link_ids, rates, n_links, kmin, kmax, pmax, queue, capacity, dt):
    """(load, new_queue, mark_prob) f32[n_links]: the one-pass step."""
    return ll.linkload_torch(link_ids, rates, queue[:n_links], capacity[:n_links],
                             kmin=kmin, kmax=kmax, pmax=pmax, dt=dt)


def linkload_cascade_ref(link_ids, rates, n_links, kmin, kmax, pmax, queue, capacity,
                         queue_mask, dt, qmax_bytes=8e6):
    """(arrival, new_queue, mark_prob) f32[n_links] and thr f32[n]: the flat
    hop cascade."""
    q1, c1, m1 = _sentinel_layout(queue, capacity, queue_mask)
    out = ll.linkload_cascade_torch(link_ids.to(torch.int32)[None], rates[None], q1, c1,
                                    m1, kmin=kmin, kmax=kmax, pmax=pmax, dt=dt,
                                    qmax_bytes=qmax_bytes)
    return tuple(o[0, :n_links] for o in out[:3]) + (out[3][0],)


def linkload_cascade_tiered_ref(fab_links, tx_link, rx_link, rates, n_links, kmin, kmax,
                                pmax, queue, capacity, queue_mask, dt, qmax_bytes=8e6):
    """(arrival, new_queue, mark_prob) f32[n_links] and thr f32[n, N]: the
    NIC-tiered hop cascade."""
    q1, c1, m1 = _sentinel_layout(queue, capacity, queue_mask)
    out = ct.cascade_tiered_torch(
        fab_links.to(torch.int32)[None], tx_link.to(torch.int32)[None],
        rx_link.to(torch.int32)[None], rates[None], q1, c1, m1, kmin=kmin, kmax=kmax,
        pmax=pmax, dt=dt, qmax_bytes=qmax_bytes)
    return tuple(o[0, :n_links] for o in out[:3]) + (out[3][0],)

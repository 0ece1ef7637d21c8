"""Chaos campaign framework: heterogeneous fault schedules, a copy of
``repro.netsim.faults`` (numpy only, so one seed draws the same campaign
and the same arrays in both packages).  It takes the port's topologies,
whose capacity is a tensor read back to numpy here.

The co-sim's original fault vocabulary (``dist.cosim.FaultEvent``) covers
clean capacity faults at EPOCH granularity — a spine dies at epoch k and
recovers at epoch k+m.  The failure modes that actually dominate RDMA
deployments (Eunomia, arXiv 2412.08540; the hyperscale issues survey,
arXiv 2302.03337) are messier: ports that FLAP on and off at sub-epoch
timescales, links that stay up but drop packets (each loss costing a
go-back-N window rewind, the paper's Table-1 amplification), PFC pause
storms freezing a link for a burst, and hosts that straggle without any
link fault at all.  This module compiles a seeded mix of those into the
operands the sweep runner already knows how to trace:

  * ``capacity_schedule(topo, epoch)`` -> f32[K, n_links+1] — a WALL-CLOCK
    capacity schedule: the horizon is cut into ``n_segments`` equal step
    windows and each active flap/pause/brown-out multiplies its links'
    capacity in the segments it covers.  K is FIXED for the whole campaign
    (healthy epochs repeat the base row), so the compiled program's shapes
    never change across epochs: the traced-capacity operand extended
    from a vector to a schedule.
  * ``loss_at(topo, epoch)`` -> f32[n_links+1] — per-link packet-loss
    rates driving ``core.gbn.gbn_goodput_factor`` inside the dataplane:
    offered load stays at the DCQCN rate (the wire carries the
    retransmissions) while goodput deflates by 1/(1 + p*W/2), so lossy
    flows occupy the fabric LONGER at full rate — offered load integrated
    over the transfer inflates by exactly the GBN waste.  Always returned
    (zeros when no lossy event is active) so the sweep operand arity —
    and therefore the compiled program — stays constant across epochs.
  * ``straggler_slowdowns(epoch)`` -> {rank: slowdown} — cadence
    stretches for ``dist.elastic.StragglerPolicy`` to chew on.
  * ``midepoch_onset(topo, epoch)`` — the earliest intra-epoch fault
    onset this epoch plus the paths it kills, the trigger for the co-sim
    loop's in-epoch replanning (``dist.cosim``).

``random_campaign`` draws a reproducible mixed campaign from a seed — the
chaos-smoke entry point for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


def _check_span(start_epoch: int, end_epoch: int | None) -> None:
    assert start_epoch >= 0, start_epoch
    if end_epoch is not None:
        assert end_epoch > start_epoch, (start_epoch, end_epoch)


def _active(start_epoch: int, end_epoch: int | None, epoch: int) -> bool:
    return start_epoch <= epoch and (end_epoch is None or epoch < end_epoch)


# ------------------------------------------------------------ event types
@dataclasses.dataclass(frozen=True)
class LinkFlap:
    """Links oscillate between healthy and ``scale`` x capacity while the
    event is active: the flap cycle is ``period_frac`` of an epoch, down
    for ``duty`` of each cycle.  ``duty=1.0`` degenerates to a steady
    fault, which combined with ``onset_frac > 0`` models a MID-EPOCH kill
    — the case that forces in-epoch replanning rather than waiting for
    the next planning round.  ``onset_frac`` only applies in the start
    epoch; later active epochs flap from their first segment."""

    links: tuple[int, ...]
    start_epoch: int
    end_epoch: int | None = None
    period_frac: float = 0.25
    duty: float = 0.5
    onset_frac: float = 0.0
    scale: float = 0.0

    def __post_init__(self):
        assert len(self.links) > 0, "flap with no links is a no-op typo"
        _check_span(self.start_epoch, self.end_epoch)
        assert 0.0 < self.period_frac <= 1.0, self.period_frac
        assert 0.0 < self.duty <= 1.0, self.duty
        assert 0.0 <= self.onset_frac < 1.0, self.onset_frac
        assert 0.0 <= self.scale < 1.0, self.scale

    def active(self, epoch: int) -> bool:
        return _active(self.start_epoch, self.end_epoch, epoch)


@dataclasses.dataclass(frozen=True)
class Brownout:
    """Steady capacity degradation at epoch granularity — the campaign
    spelling of ``dist.cosim.FaultEvent`` (which the campaign also accepts
    directly: anything with ``links`` / ``scale`` / ``active(epoch)``)."""

    links: tuple[int, ...]
    scale: float
    start_epoch: int
    end_epoch: int | None = None

    def __post_init__(self):
        assert len(self.links) > 0, "brownout with no links is a no-op typo"
        _check_span(self.start_epoch, self.end_epoch)
        assert 0.0 <= self.scale < 1.0, self.scale

    def active(self, epoch: int) -> bool:
        return _active(self.start_epoch, self.end_epoch, epoch)


@dataclasses.dataclass(frozen=True)
class PauseWindow:
    """PFC-style pause: the links transmit NOTHING for the
    [onset_frac, onset_frac + width_frac) slice of each active epoch —
    capacity pinned to zero for those segments, everything queues behind
    it.  Transient by construction, so it does NOT trigger in-epoch
    replanning (the link is healthy again before a replan could land);
    sustained storms show up through the congestion reports instead."""

    links: tuple[int, ...]
    start_epoch: int
    end_epoch: int | None = None
    onset_frac: float = 0.25
    width_frac: float = 0.25

    def __post_init__(self):
        assert len(self.links) > 0, "pause with no links is a no-op typo"
        _check_span(self.start_epoch, self.end_epoch)
        assert 0.0 <= self.onset_frac < 1.0, self.onset_frac
        assert 0.0 < self.width_frac <= 1.0, self.width_frac

    def active(self, epoch: int) -> bool:
        return _active(self.start_epoch, self.end_epoch, epoch)


@dataclasses.dataclass(frozen=True)
class LossyLink:
    """Links stay up at full capacity but drop ``loss_rate`` of packets —
    the silent-drop failure mode (optics degradation, shallow-buffer tail
    drops) that go-back-N turns into the paper's Table-1 FCT blowup.  The
    dataplane multiplies goodput by ``gbn_goodput_factor(p_loss, W)``
    while the offered rate keeps riding the wire, so the damage is
    congestion-visible, not just per-flow."""

    links: tuple[int, ...]
    loss_rate: float
    start_epoch: int
    end_epoch: int | None = None

    def __post_init__(self):
        assert len(self.links) > 0, "lossy event with no links is a no-op typo"
        _check_span(self.start_epoch, self.end_epoch)
        assert 0.0 < self.loss_rate <= 1.0, self.loss_rate

    def active(self, epoch: int) -> bool:
        return _active(self.start_epoch, self.end_epoch, epoch)


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Ring member ``rank`` takes ``slowdown`` x the healthy step time
    while active — no link fault at all, just a slow host (thermal
    throttling, a noisy neighbor).  The co-sim loop feeds the stretched
    step durations into ``dist.elastic.StragglerPolicy``; until the rank
    is quarantined it gates the bulk-synchronous cadence for everyone."""

    rank: int
    slowdown: float
    start_epoch: int
    end_epoch: int | None = None

    def __post_init__(self):
        assert self.rank >= 0, self.rank
        _check_span(self.start_epoch, self.end_epoch)
        assert self.slowdown > 1.0, self.slowdown

    def active(self, epoch: int) -> bool:
        return _active(self.start_epoch, self.end_epoch, epoch)


class Onset(NamedTuple):
    """A mid-epoch fault onset: when (fraction of the epoch horizon) and
    which paths it takes down — the in-epoch replanning trigger."""

    frac: float
    paths: tuple[int, ...]


def _event_key(ev) -> tuple:
    """Campaign-dedup identity: (kind, links-or-rank, epoch window).  Two
    events sharing a key hit the same links over the same span — whatever
    their magnitudes, composing them double-counts one physical fault
    (two identical brownouts multiply into a quadratic one)."""
    where = tuple(ev.links) if hasattr(ev, "links") else ("rank", ev.rank)
    return (type(ev).__name__, where, ev.start_epoch, ev.end_epoch)


# --------------------------------------------------------------- campaign
def _flap_down_segments(ev: LinkFlap, epoch: int, K: int) -> np.ndarray:
    """bool[K]: segments in which ``ev``'s links are down this epoch."""
    down = np.zeros(K, bool)
    if not ev.active(epoch):
        return down
    start = int(ev.onset_frac * K) if epoch == ev.start_epoch else 0
    cycle = max(1, int(round(ev.period_frac * K)))
    n_down = max(1, int(round(ev.duty * cycle)))
    for k in range(start, K):
        if ((k - start) % cycle) < n_down:
            down[k] = True
    return down


@dataclasses.dataclass(frozen=True)
class FaultCampaign:
    """A fixed mix of fault events compiled per epoch into the sweep's
    traced operands.  ``n_segments`` is the wall-clock resolution of the
    capacity schedule — constant across the campaign so every epoch (and
    every cell of a campaign grid on the same topology) shares one
    compiled program."""

    events: tuple
    n_segments: int = 8

    def __post_init__(self):
        assert self.n_segments >= 1, self.n_segments
        seen: set[tuple] = set()
        for ev in self.events:
            assert hasattr(ev, "active"), ev
            key = _event_key(ev)
            # a duplicate-seed campaign (same kind, links, window twice)
            # silently double-counts one physical fault — two stacked 0.5x
            # brownouts are a 0.25x one nobody asked for.  Reject at
            # construction; composing DIFFERENT windows/links is fine.
            assert key not in seen, \
                f"duplicate campaign event (kind, links, window): {key}"
            seen.add(key)

    def seg_steps(self, n_steps: int, align: int = 1) -> int:
        """Steps per capacity-schedule segment (the static stride the
        compact engine indexes the schedule with).  ``align`` rounds the
        stride UP to a multiple of the engine's scan-chunk length: with
        adaptive dt the chunk grid IS the event grid, and an aligned
        stride means no chunk ever straddles a capacity segment edge —
        the quiescence predicate's capacity check then never blocks a
        fast-forward mid-segment.  ``align=1`` (default) keeps the uniform
        stride."""
        base = max(1, -(-int(n_steps) // self.n_segments))
        a = max(int(align), 1)
        return -(-base // a) * a

    def capacity_schedule(self, topo, epoch: int) -> np.ndarray:
        """f32[n_segments, n_links + 1] — this epoch's wall-clock capacity
        schedule (row k covers steps [k*seg, (k+1)*seg))."""
        K = self.n_segments
        cap = np.repeat(
            np.asarray(topo.capacity.cpu(), np.float32)[None, :], K, axis=0)
        for ev in self.events:
            if isinstance(ev, (LossyLink, Straggler)):
                continue
            links = list(ev.links)
            if isinstance(ev, LinkFlap):
                down = _flap_down_segments(ev, epoch, K)
                if down.any():
                    cap[np.ix_(down, links)] *= np.float32(ev.scale)
            elif isinstance(ev, PauseWindow):
                if ev.active(epoch):
                    k0 = int(ev.onset_frac * K)
                    k1 = int(round((ev.onset_frac + ev.width_frac) * K))
                    cap[k0:max(k1, k0 + 1), links] = 0.0
            elif ev.active(epoch):  # Brownout / cosim.FaultEvent duck-type
                cap[:, links] *= np.float32(ev.scale)
        return cap

    def loss_at(self, topo, epoch: int) -> np.ndarray:
        """f32[n_links + 1] per-link packet-loss rates this epoch.  Always
        returned (zeros when clean) so the traced-operand arity — and the
        compiled program — never changes mid-campaign."""
        loss = np.zeros(topo.n_links + 1, np.float32)
        for ev in self.events:
            if isinstance(ev, LossyLink) and ev.active(epoch):
                links = list(ev.links)
                loss[links] = np.maximum(loss[links], np.float32(ev.loss_rate))
        return loss

    def has_loss(self) -> bool:
        return any(isinstance(ev, LossyLink) for ev in self.events)

    def straggler_slowdowns(self, epoch: int) -> dict[int, float]:
        out: dict[int, float] = {}
        for ev in self.events:
            if isinstance(ev, Straggler) and ev.active(epoch):
                out[ev.rank] = max(out.get(ev.rank, 1.0), ev.slowdown)
        return out

    def has_stragglers(self) -> bool:
        return any(isinstance(ev, Straggler) for ev in self.events)

    def midepoch_onset(self, topo, epoch: int) -> Onset | None:
        """The earliest intra-epoch capacity-fault onset starting THIS
        epoch, with the fabric paths its links take down — None when no
        flap begins mid-epoch (epoch-boundary faults are the planner's
        ordinary job; pause windows self-heal before a replan lands)."""
        from repro_torch.netsim.topology import paths_for_link

        hits = [ev for ev in self.events
                if isinstance(ev, LinkFlap) and ev.start_epoch == epoch
                and ev.onset_frac > 0.0]
        if not hits:
            return None
        frac = min(ev.onset_frac for ev in hits)
        paths = sorted({p for ev in hits for link in ev.links
                        for p in paths_for_link(topo, link)})
        return Onset(frac=frac, paths=tuple(paths))

    def summary(self) -> list[str]:
        return [f"{type(ev).__name__} {ev}" for ev in self.events]

    def activations(self, epoch: int) -> list[dict]:
        """JSON-able descriptions of every event active THIS epoch — the
        flight log's ``faults`` field, so the perfetto exporter can lay
        each fault's span under the epochs it perturbs."""
        out = []
        for ev in self.events:
            if not ev.active(epoch):
                continue
            d = dict(kind=type(ev).__name__, start_epoch=ev.start_epoch,
                     end_epoch=ev.end_epoch)
            for f in ("links", "rank", "scale", "loss_rate", "slowdown",
                      "duty", "period_frac", "onset_frac", "width_frac"):
                if hasattr(ev, f):
                    v = getattr(ev, f)
                    d[f] = list(v) if isinstance(v, tuple) else v
            out.append(d)
        return out

def random_campaign(topo, *, seed: int, epochs: int, n_faults: int = 3,
                    kinds: tuple[str, ...] = ("flap", "brownout", "lossy",
                                              "pause", "straggler"),
                    n_ranks: int = 0, n_segments: int = 8) -> FaultCampaign:
    """Seeded heterogeneous campaign: ``n_faults`` events drawn uniformly
    over ``kinds``, each hitting a random fabric switch (``spine_links``)
    for a 2-3 epoch span inside [1, epochs).  ``n_ranks`` (the ring size)
    must be > 0 for the "straggler" kind to be drawable.  Deterministic in
    ``seed`` — a chaos smoke test and a campaign benchmark replay the same
    schedule forever."""
    from repro_torch.netsim.topology import spine_links

    assert epochs >= 3, epochs
    kinds = tuple(k for k in kinds if k != "straggler" or n_ranks > 0)
    assert kinds, "no drawable fault kinds"
    n_spines = topo.uplink_ids.shape[1]
    rng = np.random.default_rng(seed)
    events: list = []
    keys: set[tuple] = set()
    attempts = 0
    while len(events) < n_faults:
        # a colliding (kind, links, window) draw would be rejected by
        # FaultCampaign as a double-counted fault — redraw instead (the
        # no-collision path consumes the exact legacy RNG sequence, so
        # existing seeded campaigns replay unchanged)
        attempts += 1
        assert attempts <= 100 * n_faults, \
            "random_campaign cannot draw enough distinct faults"
        kind = str(rng.choice(kinds))
        start = int(rng.integers(1, max(epochs - 2, 2)))
        end = min(epochs, start + int(rng.integers(2, 4)))
        spine = int(rng.integers(n_spines))
        links = spine_links(topo, spine)
        if kind == "flap":
            ev = LinkFlap(
                links=links, start_epoch=start, end_epoch=end,
                period_frac=float(rng.uniform(0.25, 0.5)),
                duty=float(rng.uniform(0.3, 0.7)),
                onset_frac=float(rng.uniform(0.2, 0.6)))
        elif kind == "brownout":
            ev = Brownout(
                links=links, scale=float(rng.uniform(0.1, 0.5)),
                start_epoch=start, end_epoch=end)
        elif kind == "lossy":
            ev = LossyLink(
                links=links, loss_rate=float(rng.uniform(0.005, 0.05)),
                start_epoch=start, end_epoch=end)
        elif kind == "pause":
            ev = PauseWindow(
                links=links, start_epoch=start, end_epoch=end,
                onset_frac=float(rng.uniform(0.1, 0.5)),
                width_frac=float(rng.uniform(0.1, 0.3)))
        else:  # straggler
            ev = Straggler(
                rank=int(rng.integers(n_ranks)),
                slowdown=float(rng.uniform(2.0, 4.0)),
                start_epoch=start, end_epoch=end)
        key = _event_key(ev)
        if key in keys:
            continue
        keys.add(key)
        events.append(ev)
    return FaultCampaign(events=tuple(events), n_segments=n_segments)


# ------------------------------------------------------ telemetry channel
@dataclasses.dataclass
class TelemetryChannel:
    """The degraded CONTROL plane: a seeded model of the feedback path that
    carries congestion reports (and liveness heartbeats) from the fabric
    back to the planner.  The chaos campaign above makes the *data* plane
    hostile; this makes the *report* path hostile — at hyperscale the
    feedback channel is itself lossy and delayed (arXiv 2302.03337), and a
    no-reordering balancer that trusts stale or duplicated reports breaks
    its own invariant (arXiv 2412.08540).

    Per report: dropped with probability ``loss``; otherwise delivered
    ``delay_epochs`` (+ uniform extra in [0, jitter_epochs]) planning
    epochs after it was sent — jitter makes deliveries REORDER across
    epochs; with probability ``dup`` a second, independently delayed copy
    is delivered too.  ``reorder`` additionally shuffles the within-epoch
    delivery order (seeded).  ``blackout=(b0, b1)`` models a dead feedback
    path: any report SENT or DELIVERED inside [b0, b1) is lost — the
    scenario that must trip ``dist.elastic.TelemetryWatchdog``.

    Deterministic in ``seed`` and the send sequence; ``state``/``restore``
    round-trip the queue, the counters, and the RNG through the co-sim
    journal so a resumed campaign replays bit-identically.  A channel
    constructed with all-default degradation (loss=0, delay=0, jitter=0,
    dup=0, no blackout) delivers every report exactly once in order in its
    send epoch — bit-identical planner behavior to no channel at all (the
    property-tested perfect-channel contract)."""

    loss: float = 0.0
    delay_epochs: int = 0
    jitter_epochs: int = 0
    dup: float = 0.0
    reorder: bool = False
    seed: int = 0
    blackout: tuple[int, int] | None = None

    def __post_init__(self):
        assert 0.0 <= self.loss <= 1.0, self.loss
        assert 0.0 <= self.dup <= 1.0, self.dup
        assert self.delay_epochs >= 0 and self.jitter_epochs >= 0
        if self.blackout is not None:
            b0, b1 = self.blackout
            assert 0 <= b0 < b1, self.blackout
        self._rng = np.random.default_rng(self.seed)
        self._pending: dict[int, list[tuple[tuple, int]]] = {}
        self.sent = 0
        self.dropped = 0
        self.delivered = 0

    def config(self) -> dict:
        """JSON-stable identity of the channel's degradation parameters
        (the co-sim journal's spec key — a different channel is a
        different campaign)."""
        return dict(
            loss=float(self.loss), delay_epochs=int(self.delay_epochs),
            jitter_epochs=int(self.jitter_epochs), dup=float(self.dup),
            reorder=bool(self.reorder), seed=int(self.seed),
            blackout=None if self.blackout is None else
            [int(self.blackout[0]), int(self.blackout[1])],
        )

    def _blacked_out(self, epoch: int) -> bool:
        return self.blackout is not None \
            and self.blackout[0] <= epoch < self.blackout[1]

    def _arrival(self, epoch: int) -> int:
        extra = int(self._rng.integers(0, self.jitter_epochs + 1)) \
            if self.jitter_epochs else 0
        return epoch + self.delay_epochs + extra

    def send(self, payload: tuple, epoch: int) -> None:
        """Emit one epoch-stamped report.  ``payload`` is an opaque tuple
        (``dist.cosim`` sends ``("slow", path)`` and ``("hb", leaf)``)."""
        self.sent += 1
        # draw loss/dup/jitter unconditionally so the RNG stream — and
        # therefore every later report's fate — does not depend on whether
        # THIS epoch fell inside a blackout window
        lost = self.loss > 0.0 and float(self._rng.random()) < self.loss
        arrive = self._arrival(epoch)
        duped = self.dup > 0.0 and float(self._rng.random()) < self.dup
        arrive2 = self._arrival(epoch) + 1 if duped else -1
        if lost or self._blacked_out(epoch):
            self.dropped += 1
            return
        self._pending.setdefault(arrive, []).append((tuple(payload), epoch))
        if duped:
            self._pending.setdefault(arrive2, []).append(
                (tuple(payload), epoch))

    def deliver(self, epoch: int) -> list[tuple[tuple, int]]:
        """All (payload, origin_epoch) reports arriving by ``epoch`` that
        were not already collected — reports whose delivery epoch lands in
        a blackout window are lost in flight.  Call once per epoch, in
        epoch order."""
        batch: list[tuple[tuple, int]] = []
        for k in sorted(e for e in self._pending if e <= epoch):
            batch.extend(self._pending.pop(k))
        if self._blacked_out(epoch):
            self.dropped += len(batch)
            return []
        if self.reorder and len(batch) > 1:
            batch = [batch[i] for i in self._rng.permutation(len(batch))]
        self.delivered += len(batch)
        return batch

    def state(self) -> dict:
        """JSON-able snapshot (queue + counters + RNG) for the co-sim
        journal; ``restore`` makes a resumed run replay bit-identically."""
        return dict(
            pending={str(k): [[list(p), o] for p, o in v]
                     for k, v in self._pending.items()},
            sent=self.sent, dropped=self.dropped, delivered=self.delivered,
            rng=self._rng.bit_generator.state,
        )

    def restore(self, state: dict) -> None:
        self._pending = {
            int(k): [(tuple(p), int(o)) for p, o in v]
            for k, v in state.get("pending", {}).items()
        }
        self.sent = int(state.get("sent", 0))
        self.dropped = int(state.get("dropped", 0))
        self.delivered = int(state.get("delivered", 0))
        if state.get("rng"):
            self._rng.bit_generator.state = state["rng"]

"""Fault tolerance: the training supervisor, and for the MWIS reduction
fault injection, restart and elastic re-partitioning.

Port of :mod:`repro.distributed.fault`.

  * **Node loss** — training: checkpoint/restart is the recovery
    primitive; :class:`TrainSupervisor` wraps the step loop with save
    cadence + restore-on-restart + deterministic data-skip so restarts
    replay no batch twice.  MWIS: the reduction state (w, status, fold
    log, offset) *is* the checkpoint: rounds are idempotent from any
    consistent state, so restart = reload + continue
    (:class:`~repro_torch.distributed.checkpoint.CheckpointManager`).
  * **Stragglers** — DisReduA's bounded-staleness exchange already removes
    the per-round straggler barrier (a slow PE delays neighbors by at most
    one halo exchange, not the whole fixpoint).  For training, the
    supervisor keeps a rolling step-time EWMA and flags outliers
    (:class:`StragglerMonitor`).
  * **Elastic scaling** — :func:`remesh_plan` recomputes the vertex
    partition for a new p and maps old→new PE state.
  * **Chaos engineering** — :class:`FaultPlan` + :func:`run_union_reduction`
    are the deterministic fault-injection harness for the DisRedu exchange
    loop: a seeded plan delays or drops one PE's halo board for k rounds
    (a straggler / lost message under bounded staleness, §5.4), corrupts a
    weight plane (bit-rot on the wire or in memory), or kills the run
    mid-sweep (node loss).  The harness drives the round loop from the
    host through the :func:`repro_torch.core.exchange.union_boards` /
    ``reconcile_union_boards`` seam, checks the reduction monotonicity
    invariants every round (weights never increase; decided vertices never
    revert to UNDECIDED — exactly why stale boards are safe, Lemma 4.2),
    and checkpoints ``RedState`` so restart-from-checkpoint is
    bit-identical to an uninterrupted run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import exchange as X
from repro_torch.core import rules as R
from repro_torch.core.local_reduce import local_reduce
from repro_torch.distributed.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerMonitor:
    """Rolling EWMA of step times; flags steps slower than factor×EWMA."""

    alpha: float = 0.1
    factor: float = 2.0
    ewma: Optional[float] = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt
        )
        if slow:
            self.flagged += 1
        return slow


class TrainSupervisor:
    """Checkpoint-cadenced, restart-safe runner of a training step loop.

    The data pipeline must be indexable by step (deterministic): on restore
    the loop resumes at ``resume_step()`` without replaying batches.  The
    state is restored into the template's structure, onto its leaves'
    devices and dtypes (``CheckpointManager.restore``).
    """

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 100,
                 straggler: Optional[StragglerMonitor] = None):
        self.ckpt = ckpt
        self.save_every = save_every
        self.straggler = straggler or StragglerMonitor()
        self.events: list = []

    def resume_step(self) -> int:
        latest = self.ckpt.latest_step()
        return 0 if latest is None else latest + 1

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int, *, state_template: Optional[Any] = None) -> Any:
        start = self.resume_step()
        if start > 0:
            state = self.ckpt.restore(
                state_template if state_template is not None else state)
            self.events.append(("restored", start - 1))
        for step in range(start, n_steps):
            t0 = time.monotonic()
            state = step_fn(state, step)
            dt = time.monotonic() - t0
            if self.straggler.observe(dt):
                self.events.append(("straggler", step, dt))
            if (step + 1) % self.save_every == 0 or step == n_steps - 1:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state


class InjectedFault(RuntimeError):
    """Raised by :func:`run_union_reduction` at a FaultPlan kill point."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, fully deterministic fault schedule for one reduction run.

    Rounds are 0-based indices of the harness round loop.  A PE index of
    ``-1`` (or a round of ``-1``) disables that fault.  All faults compose.

      * delay — PE ``delay_pe``'s published board lags ``delay_rounds``
        rounds behind, starting at round ``delay_from`` (a straggler under
        bounded staleness: neighbors keep reducing on stale-but-valid
        upper bounds, Lemma 4.2).
      * drop — PE ``drop_pe``'s board is not delivered at all for
        ``drop_rounds`` rounds from ``drop_from`` (lost messages: receivers
        keep the last board they saw).
      * corrupt — at round ``corrupt_round``, one of PE ``corrupt_pe``'s
        local weights is bumped *up* by a seeded amount — a monotonicity
        violation the harness's invariant checker must flag.
      * kill — :class:`InjectedFault` is raised at the start of round
        ``kill_round`` (mid-sweep node loss; recover via checkpoints).
    """

    seed: int = 0
    delay_pe: int = -1
    delay_rounds: int = 0
    delay_from: int = 0
    drop_pe: int = -1
    drop_rounds: int = 0
    drop_from: int = 0
    corrupt_pe: int = -1
    corrupt_round: int = -1
    kill_round: int = -1

    @staticmethod
    def random_delay(seed: int, p: int, *, max_delay: int = 3) -> "FaultPlan":
        """Seeded straggler plan: one random PE, random lag/onset."""
        rng = np.random.default_rng(seed)
        return FaultPlan(
            seed=seed,
            delay_pe=int(rng.integers(0, p)),
            delay_rounds=int(rng.integers(1, max_delay + 1)),
            delay_from=int(rng.integers(0, 3)),
        )


def _with_row(boards: torch.Tensor, pe: int,
              src: torch.Tensor) -> torch.Tensor:
    """``boards`` with PE ``pe``'s row taken from ``src`` (a new tensor)."""
    out = boards.clone()
    out[pe] = src[pe]
    return out


def run_union_reduction(
    prob,
    cfg,
    *,
    faults: Optional[FaultPlan] = None,
    state=None,
    start_round: int = 0,
    max_rounds: Optional[int] = None,
    ckpt: Optional[CheckpointManager] = None,
    save_every: int = 1,
    check_invariants: bool = True,
) -> Tuple[Any, int, Dict[str, Any]]:
    """Host-driven DisRedu round loop with deterministic fault injection.

    Semantically the same reduction as
    :func:`repro_torch.core.distributed.disredu_union` (local_reduce → halo
    exchange → repeat until no global change), but each round publishes
    its boards and reconciles them as two steps, so faults can be injected
    *between* board publication and delivery — exactly where a real
    deployment loses or delays messages.  Each round is a deterministic
    function of ``state`` alone, so a run restored from a ``RedState``
    checkpoint is bit-identical to an uninterrupted one.

    Args:
      prob: a ``UnionProblem`` (``distributed.build_union_problem``).
      cfg: a ``DisReduConfig`` (schedule/backend/sweeps as usual).
      faults: optional :class:`FaultPlan`; None runs fault-free.
      state: resume state (e.g. a restored checkpoint, on ``prob``'s
        device); None starts fresh.
      start_round: round index to resume at (fault rounds are absolute).
      ckpt: optional :class:`CheckpointManager`; saves ``RedState`` every
        ``save_every`` completed rounds (atomic commit, integrity-hashed).
      check_invariants: verify per round that weights never increase and
        decided vertices never revert (violations recorded, not raised).

    Returns ``(state, rounds_done, report)`` where report carries
    ``fixpoint`` (bool), ``events`` (applied faults), and ``violations``
    (invariant breaches, e.g. from an injected weight corruption).
    """
    fp = faults or FaultPlan()
    limit = cfg.max_rounds if max_rounds is None else max_rounds
    if state is None:
        state = R.init_state(prob.w0, prob.is_local, prob.is_ghost)

    V = prob.V if prob.V else prob.w0.shape[0] // prob.p
    events: List[tuple] = []
    violations: List[tuple] = []
    # hist[0] = boards of the entry state; hist[t+1] = boards published in
    # round (start_round + t).  Resumed runs rebuild history lazily — a
    # delay fault reaching past the resume point sees the entry boards,
    # the most conservative (stalest) legal message.
    hist: List[tuple] = [X.union_boards(state, prob.halo)]
    rounds = 0
    fixpoint = False

    for t in range(start_round, start_round + limit):
        if t == fp.kill_round:
            events.append(("killed", t))
            raise InjectedFault(f"FaultPlan kill at round {t}")
        snap_w = state.w.cpu().numpy()
        snap_status = state.status.cpu().numpy()

        state = local_reduce(
            state, prob.aux, heavy_k=cfg.heavy_k, use_heavy=cfg.use_heavy,
            max_sweeps=cfg.sweeps_per_round, schedule=cfg.schedule,
            backend=cfg.backend, plan=prob.plan,
        )

        if fp.corrupt_pe >= 0 and t == fp.corrupt_round:
            rng = np.random.default_rng(fp.seed)
            # corrupt a *local* slot (ghost slots are re-clamped by the
            # owner's board on reconcile — min() would mask the fault) and
            # bump past the round-entry maximum: weights only ever
            # decrease, so this is an unambiguous monotonicity breach
            lo, hi = fp.corrupt_pe * V, (fp.corrupt_pe + 1) * V
            local = np.flatnonzero(prob.is_local.cpu().numpy()[lo:hi])
            idx = lo + int(local[rng.integers(0, local.size)])
            bump = int(snap_w.max()) + int(rng.integers(1, 1000))
            w = state.w.clone()
            w[idx] += bump
            state = state._replace(w=w)
            events.append(("corrupted", t, fp.corrupt_pe, idx, bump))

        bw, bs = X.union_boards(state, prob.halo)
        hist.append((bw, bs))
        eff_w, eff_s = bw, bs
        hi = len(hist) - 1  # index of this round's boards
        if fp.delay_pe >= 0 and fp.delay_rounds > 0 and t >= fp.delay_from:
            src_w, src_s = hist[max(0, hi - fp.delay_rounds)]
            eff_w = _with_row(eff_w, fp.delay_pe, src_w)
            eff_s = _with_row(eff_s, fp.delay_pe, src_s)
            events.append(("delayed", t, fp.delay_pe))
        if (fp.drop_pe >= 0
                and fp.drop_from <= t < fp.drop_from + fp.drop_rounds):
            # receivers keep the last board delivered before the outage
            src_w, src_s = hist[max(0, fp.drop_from - start_round)]
            eff_w = _with_row(eff_w, fp.drop_pe, src_w)
            eff_s = _with_row(eff_s, fp.drop_pe, src_s)
            events.append(("dropped", t, fp.drop_pe))

        state, _ = X.reconcile_union_boards(
            state, prob.aux, prob.halo, eff_w, eff_s, backend=cfg.backend,
            plan=prob.plan,
        )
        rounds += 1

        new_w = state.w.cpu().numpy()
        new_status = state.status.cpu().numpy()
        if check_invariants:
            up = new_w > snap_w
            if np.any(up):
                violations.append(
                    ("weight_increased", t, [int(i) for i in
                                             np.flatnonzero(up)[:8]])
                )
            revert = (snap_status != 0) & (new_status == 0)
            if np.any(revert):
                violations.append(
                    ("decided_reverted", t, [int(i) for i in
                                             np.flatnonzero(revert)[:8]])
                )

        if ckpt is not None and (rounds % max(save_every, 1) == 0):
            ckpt.save(t, state)
            ckpt.wait()

        changed = (not np.array_equal(new_status, snap_status)
                   or not np.array_equal(new_w, snap_w))
        # Bounded staleness: a stale board is eventually delivered, so the
        # loop may only declare fixpoint on an unchanged round whose
        # delivered boards equal the fresh ones.  While the state is
        # stable the lagged history catches up within delay_rounds rounds,
        # so this terminates — and it is exactly why delayed runs reach
        # the SAME fixpoint as fault-free ones (Lemma 4.2).
        fresh = torch.equal(eff_w, bw) and torch.equal(eff_s, bs)
        if not changed and fresh:
            fixpoint = True
            break

    report = dict(fixpoint=fixpoint, events=events, violations=violations)
    return state, rounds, report


def remesh_plan(n_global: int, p_old: int, p_new: int) -> Dict[str, Any]:
    """Vertex-block mapping for elastic MWIS re-partitioning.

    Contiguous blocks make elastic remaps pure interval arithmetic: each new
    PE's block is covered by a small set of old-PE intervals.  Returns, for
    every new PE, the (old_pe, old_lo, old_hi, new_lo) copy descriptors a
    deployment would turn into point-to-point transfers.
    """
    old = np.linspace(0, n_global, p_old + 1).astype(np.int64)
    new = np.linspace(0, n_global, p_new + 1).astype(np.int64)
    plan = []
    for j in range(p_new):
        lo, hi = int(new[j]), int(new[j + 1])
        segs = []
        for i in range(p_old):
            a, b = max(lo, int(old[i])), min(hi, int(old[i + 1]))
            if a < b:
                segs.append(
                    dict(old_pe=i, old_lo=a - int(old[i]),
                         old_hi=b - int(old[i]), new_lo=a - lo, size=b - a)
                )
        plan.append(segs)
    return {"p_old": p_old, "p_new": p_new, "copies": plan}

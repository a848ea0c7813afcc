"""mwis — the paper's own workload as a selectable architecture.

A copy of the reference's ``MWIS_SHAPES`` and ``MWIS_DESCENT_LADDER``
(``repro/configs/base.py``; ``configs/base.py`` re-exports them), and of
its helpers, ``smoke`` and ``ARCH`` (``repro/configs/mwis.py``); the
reference modules import JAX, so the port keeps its own copy instead of
importing them.

The dry-run cells follow the paper's weak-scaling setup (§7: per-PE
vertices and edges as on HoreKa) plus a strong-scaling RnP cell; each
carries the named rule schedule its rounds run (an ``engine.SCHEDULES``
key): the fused hot path for the reduce cells, the cheaper windowless
schedule for RnP, and the blocked-ELL row-block height in ``seg_blk``.

Serving cells (MWIS-as-a-service) are the single-PE buckets the batched
front end (:mod:`repro_torch.core.serve`) pads small and medium instances
into: an incoming instance lands in the smallest cell with ``L >= n`` and
``E >= 2m``.  G/B/S are the min_pad floors (p=1 has no halo); D is the
serve window cap; ``seg_blk`` fixes the blocked-ELL row-block height per
cell (a batch shares one ``r_blk``) and ``e_blk`` floors the shared edge
budget (the serving layer grows it as a high-water mark).
``serve_devices`` caps how many serve-mesh devices a cell's batch axis is
split over (None: the whole mesh) and ``pipeline`` opts a cell out of the
overlapped chunk pipeline; :func:`serve_knobs` reads both, as the
service's ``ServeCell`` rows do.
Descent cells are the rungs above ``serve_m`` that the staged solver
(:func:`repro_torch.core.solvers.solve_staged`) re-packs onto, and the
entry shapes of instances too large for every serve cell.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs import base

MWIS_SHAPES: Dict[str, Dict[str, Any]] = {
    # weak-scaling cells (paper §7): per-PE vertices/edges as on HoreKa
    "weak_1m": dict(kind="reduce", L=1 << 20, E=1 << 23, G=1 << 16,
                    B=1 << 16, S=1 << 10, D=16, Dc=4,
                    schedule="cheap-fused", seg_blk=dict(r_blk=32)),
    "weak_4m": dict(kind="reduce", L=1 << 22, E=1 << 25, G=1 << 17,
                    B=1 << 17, S=1 << 11, D=16, Dc=4,
                    schedule="cheap-fused", seg_blk=dict(r_blk=32)),
    "strong_128m": dict(kind="rnp", L=1 << 18, E=1 << 21, G=1 << 15,
                        B=1 << 15, S=1 << 10, D=16, Dc=4,
                        schedule="edges-only", seg_blk=dict(r_blk=8)),
    "serve_xs": dict(kind="serve", L=64, E=1024, G=4, B=4, S=4, D=8,
                     Dc=4, schedule="cheap-fused",
                     seg_blk=dict(r_blk=8, e_blk=64),
                     serve_devices=None, pipeline=True),
    "serve_s": dict(kind="serve", L=256, E=4096, G=4, B=4, S=4, D=8,
                    Dc=4, schedule="cheap-fused",
                    seg_blk=dict(r_blk=16, e_blk=160),
                    serve_devices=None, pipeline=True),
    "serve_m": dict(kind="serve", L=1024, E=16384, G=4, B=4, S=4, D=8,
                    Dc=4, schedule="cheap-fused",
                    seg_blk=dict(r_blk=32, e_blk=320),
                    serve_devices=None, pipeline=True),
    "descent_l": dict(kind="descent", L=4096, E=65536, G=64, B=64, S=64,
                      D=8, Dc=4, schedule="cheap-fused",
                      seg_blk=dict(r_blk=32, e_blk=512)),
    "descent_xl": dict(kind="descent", L=16384, E=262144, G=128, B=128,
                       S=128, D=8, Dc=4, schedule="cheap-fused",
                       seg_blk=dict(r_blk=32, e_blk=1024)),
}

#: Ladder order (ascending) used by solvers.solve_staged when no explicit
#: ladder is given: serve cells first, then the descent extensions.
MWIS_DESCENT_LADDER = (
    "serve_xs", "serve_s", "serve_m", "descent_l", "descent_xl",
)

#: Static batch-size buckets of the serving layer: a request batch is
#: padded up to the smallest admissible size.
MWIS_SERVE_BATCH_SIZES = (1, 4, 16, 64)


def rule_schedule(shape_name: str) -> str:
    """The named rule schedule a shape cell reduces with."""
    return MWIS_SHAPES[shape_name].get("schedule", "cheap-fused")


def serve_knobs(shape_name: str) -> dict:
    """Per-cell multi-device serving knobs of a kind="serve" shape row:
    ``serve_devices`` caps the batch-axis mesh for the cell (None = whole
    serve mesh), ``pipeline`` opts the cell out of the overlapped chunk
    pipeline."""
    meta = MWIS_SHAPES[shape_name]
    return dict(serve_devices=meta.get("serve_devices"),
                pipeline=meta.get("pipeline", True))


def serve_cell_names() -> tuple:
    """The single-PE serving buckets (kind="serve"), in ascending size
    order — the bucket table of the batched front end."""
    cells = [(name, meta) for name, meta in MWIS_SHAPES.items()
             if meta.get("kind") == "serve"]
    cells.sort(key=lambda kv: (kv[1]["L"], kv[1]["E"]))
    return tuple(name for name, _ in cells)


def smoke(device: str = "cuda") -> None:
    from repro_torch.configs.smoke_runners import mwis_smoke

    mwis_smoke(device=device)


ARCH = base.ArchDef(
    arch_id="mwis",
    family="mwis",
    # serve cells are single-PE buckets of the batched serving front end
    # and descent cells are mid-solve re-pack rungs — neither is a
    # dry-run workload
    shapes=tuple(s for s, m in MWIS_SHAPES.items()
                 if m.get("kind") not in ("serve", "descent")),
    build=base.mwis_build,
    smoke=smoke,
)

"""Weight -> crossbar-tile placement (port of ``repro.hw.mapper``, DESIGN.md
§6).

The mapper answers "how many crossbar macros does this model need, and how
well are they filled?". It walks a parameter tree (tensors, or the
``ParamSpec`` tree of a ``ModelConfig``: no allocation, so the
trillion-parameter configs map in milliseconds) with the weight cache's
per-leaf rules (``models/common.leaf_rule_with_reason``), reshapes each
dense-eligible leaf the way its consumer does —

    dense    — w.reshape(w.shape[0], -1)
    dense_in — w.reshape(-1, w.shape[-1])
    expert   — the dense rule per expert, x num_experts copies
    tied head — the embedding table read transposed (d_model, vocab)

— and covers the resulting 2-D matrix with a grid of ``TileGeometry``
tiles. Everything the cache excludes is reported as *unmapped* with the
shared reason string.

The port holds one dict per layer where the reference stacks each run of
equal layer kinds along a leading ``(layers,)`` dim. The walk places a run
as the reference places its stacked group: leaf by leaf, in sorted-key
order, each leaf one placement whose copies are the run's layers (times
the experts). So the placements, their order and their tile-id spans are
the reference's; only the keys name the run (``['layers'][0:3]...``).

Conservation invariant: for every mapped leaf, rows*cols cells are covered
exactly once per copy — ``cells_used == rows * cols`` and
``0 < utilization <= 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.hw.arrays import DEFAULT_GEOMETRY, TileGeometry
from repro_torch.models import common

Tree = Any


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    """One dense-eligible leaf on the tile inventory.

    rows/cols   — the 2-D matrix shape under the consumer's reshape rule.
    copies      — structural replicas holding DISTINCT weights: the layers
                  of a run x the experts of an MoE stack.
    tiles_r/c   — tile grid covering one copy.
    """

    key: str
    rule: str
    rows: int
    cols: int
    copies: int
    tiles_r: int
    tiles_c: int
    group: Optional[int] = None   # layer-run index (None = outside layers)

    @property
    def tiles_per_copy(self) -> int:
        return self.tiles_r * self.tiles_c

    @property
    def cells_used_per_copy(self) -> int:
        return self.rows * self.cols

    def tiles(self, geom: TileGeometry) -> int:
        """Physical tiles including read-bandwidth duplication."""
        return self.tiles_per_copy * self.copies * geom.duplication

    def cells_alloc_per_copy(self, geom: TileGeometry) -> int:
        return self.tiles_per_copy * geom.cells_per_tile

    def utilization(self, geom: TileGeometry) -> float:
        return self.cells_used_per_copy / self.cells_alloc_per_copy(geom)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Full-model placement report."""

    name: str
    geometry: TileGeometry
    leaves: Tuple[LeafPlacement, ...]
    unmapped: Tuple[Tuple[str, str], ...]   # (key, shared exclusion reason)

    @property
    def tiles(self) -> int:
        return sum(lp.tiles(self.geometry) for lp in self.leaves)

    @property
    def macros(self) -> int:
        return self.geometry.macros_for(self.tiles)

    @property
    def cells_used(self) -> int:
        """Weight cells holding distinct parameters (one copy each)."""
        return sum(lp.cells_used_per_copy * lp.copies for lp in self.leaves)

    @property
    def cells_written_per_update(self) -> int:
        """Cells programmed per optimizer step: every placed weight, in
        every duplicated copy, is rewritten by the in-situ dW update."""
        return self.cells_used * self.geometry.duplication

    @property
    def utilization(self) -> float:
        alloc = sum(lp.cells_alloc_per_copy(self.geometry) * lp.copies
                    * self.geometry.duplication for lp in self.leaves)
        return (self.cells_used * self.geometry.duplication / alloc
                if alloc else 0.0)

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for lp in self.leaves:
            out[lp.rule] = out.get(lp.rule, 0) + lp.tiles(self.geometry)
        return out

    def tile_spans(self) -> Tuple[Tuple[str, int, int], ...]:
        """Physical tile-id ranges per leaf, in leaf order: (key, start,
        stop), ``stop - start == leaves[i].tiles(geometry)``; the last
        ``stop`` is ``self.tiles``. The wear books
        (``hw.schedule.TileWearBook``) key on these ids."""
        spans: List[Tuple[str, int, int]] = []
        start = 0
        for lp in self.leaves:
            n = lp.tiles(self.geometry)
            spans.append((lp.key, start, start + n))
            start += n
        return tuple(spans)


def _mapped_shape(shape: tuple, rule: str) -> Tuple[int, int, int]:
    """(rows, cols, copies-from-rule) of one leaf under its reshape rule.
    For "expert", ``shape`` is the full (E, ...) stack."""
    if rule == "dense":
        return shape[0], math.prod(shape[1:]), 1
    if rule == "dense_in":
        return math.prod(shape[:-1]), shape[-1], 1
    if rule == "expert":
        e = shape[0]
        per = shape[1:]
        return per[0], math.prod(per[1:]), e
    raise ValueError(rule)


def _keystr(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def _shape_dtype(leaf, cfg: ModelConfig) -> tuple:
    if isinstance(leaf, common.ParamSpec):
        return tuple(leaf.shape), cfg.param_torch_dtype
    return tuple(leaf.shape), leaf.dtype


def _place(tree: Tree, prefix: str, layers: int, group: Optional[int],
           cfg: ModelConfig, geom: TileGeometry, leaves: list,
           unmapped: list) -> None:
    """Place every leaf of one per-layer (sub)tree, ``layers`` copies."""
    for path, leaf in tree_lib.leaves_with_path(tree):
        key = prefix + _keystr(path)
        shape, dtype = _shape_dtype(leaf, cfg)
        rule, reason = common.leaf_rule_with_reason(path, len(shape), dtype)
        if rule is None:
            unmapped.append((key, reason))
            continue
        rows, cols, e_copies = _mapped_shape(shape, rule)
        tiles_r, tiles_c = geom.tiles_for(rows, cols)
        leaves.append(LeafPlacement(
            key=key, rule=rule, rows=rows, cols=cols,
            copies=layers * e_copies, tiles_r=tiles_r, tiles_c=tiles_c,
            group=group))


def layer_runs(cfg: ModelConfig) -> List[Tuple[str, int, int]]:
    """(kind, first layer, count) of each run of equal layer kinds: the
    reference's layer groups, each one scan there."""
    runs: List[Tuple[str, int, int]] = []
    for i, k in enumerate(cfg.layer_kinds()):
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((k, i, 1))
    return runs


def map_params(params: Tree, cfg: ModelConfig, *, name: Optional[str] = None,
               geom: TileGeometry = DEFAULT_GEOMETRY) -> Placement:
    """Place a model parameter tree (tensors or ``ParamSpec``s), in the
    weight cache's traversal: the leaves outside the layers, the tied
    head (the transposed table), then each run of equal layers."""
    if geom.rows != cfg.tf.block:
        raise ValueError(
            f"tile height {geom.rows} must equal the alignment block "
            f"{cfg.tf.block}: one chunk scalar product spans one tile column")
    leaves: List[LeafPlacement] = []
    unmapped: List[Tuple[str, str]] = []
    top = {k: v for k, v in params.items() if k != "layers"}
    _place(top, "", 1, None, cfg, geom, leaves, unmapped)
    emb = params.get("embed")
    if cfg.tie_embeddings and emb is not None and len(emb.shape) == 2:
        # The tied LM head reads the embedding table transposed (d, V);
        # that read is a crossbar matmul, so the transposed table is
        # placed although gather-read embeddings are not.
        v, d = emb.shape
        tiles_r, tiles_c = geom.tiles_for(d, v)
        leaves.append(LeafPlacement(
            key="['embed']", rule="dense", rows=d, cols=v, copies=1,
            tiles_r=tiles_r, tiles_c=tiles_c))
    for gi, (_kind, first, count) in enumerate(layer_runs(cfg)):
        _place(params["layers"][first],
               f"['layers'][{first}:{first + count}]", count, gi, cfg, geom,
               leaves, unmapped)
    return Placement(name=name or cfg.name, geometry=geom,
                     leaves=tuple(leaves), unmapped=tuple(unmapped))


def map_model(cfg: ModelConfig, *,
              geom: TileGeometry = DEFAULT_GEOMETRY) -> Placement:
    """Shape-only placement of a ``ModelConfig``: the ``ParamSpec`` tree,
    no parameter allocated (usable on the 1T-parameter configs)."""
    from repro_torch.models import model as model_lib

    return map_params(model_lib.model_param_specs(cfg), cfg, geom=geom)


def map_edge_mlp(cfg, *, geom: TileGeometry = DEFAULT_GEOMETRY) -> Placement:
    """Placement of the paper-scale edge MLP (``configs/timefloats_mlp.py``,
    an ``EdgeMLPConfig``): consecutive dense layers in -> hidden ... ->
    classes."""
    if geom.rows != cfg.tf.block:
        raise ValueError(f"tile height {geom.rows} != block {cfg.tf.block}")
    dims = (cfg.in_dim, *cfg.hidden, cfg.n_classes)
    leaves = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        tiles_r, tiles_c = geom.tiles_for(k, n)
        leaves.append(LeafPlacement(
            key=f"['w{i + 1}']", rule="dense", rows=k, cols=n, copies=1,
            tiles_r=tiles_r, tiles_c=tiles_c))
    return Placement(name=cfg.name, geometry=geom, leaves=tuple(leaves),
                     unmapped=())

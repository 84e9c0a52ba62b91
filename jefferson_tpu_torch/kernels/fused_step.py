"""The fused render steps: CUDA kernels, their plain-PyTorch twins, and the
wrappers that pick one by where the operands lie.

Counterparts of ``jefferson_tpu/pallas/fused_step.py``, with the JAX
wrappers' names and array layouts (the TPU-only arguments tile, interpret,
lane512, tail_tree, single_blend, mstack_tail and fwd512 are gone):

==========================================  ====  =============================
wrapper (JAX wrapper line)                  row   CUDA source
==========================================  ====  =============================
fused_step_onehot_xfade (:721), one         1     csrc/fused_step_onehot.cu
shared table
fused_step_onehot_xfade with group_tiles    2     csrc/fused_step_onehot.cu
fused_step_stream_onehot_xfade (:517)       3     csrc/fused_step_onehot.cu
fused_step_stream_onehot_grouped_xfade      4     csrc/fused_step_onehot.cu
(:615)
fused_step_stream_xfade (:971), both        5     csrc/fused_step_gather.cu
``with_xfade`` forms
fused_step_xfade (:1064), both forms        6     csrc/fused_step_gather.cu
==========================================  ====  =============================

Rows 1-4 replace the TPU body ``_onehot_kernel`` (:347), rows 5 and 6 the
body ``_kernel`` (:868); row 7, the apply-only step, is in
``kernels/fused_apply.py``.  Per output row r they compute the sliding
sub-block forward DFT, the distance planes (per row, or selected from <= 8
unique triples), the old and new filter rows (blended from a compact table
in rows 1-4; arriving pre-blended in rows 5 and 6), the per-ear tail IDFT
of each, and the crossfade where ``xf > 0``.  Output: (rows, 2*fpb) =
[L fpb | R fpb].  The CUDA sources' headers say what bounds each kernel on
the H100 and how its design answers that.

Operands on the CPU run the plain twin (``*_reference``); operands on a
CUDA device run the kernel, or the wrapper raises (no fallback).  On the
card, launch B of rows 2-7 has two forms with the same bits, chosen by
``pick_form`` (the choice of shape, not a fallback): one CTA per 32
rows, or the split form, a cluster of CTAs per tile, one per 128-bin
block (``csrc/fused_forward.cuh``, in the layout ``split_default``
names by the kind of row and the t-tiles).  Launch A, the forward every step of rows 1-6 runs first,
takes its product form, or its few-block form up to ``FEW_NB`` blocks a
source, or where neither exists its tile form, or its ring form up to fpb
32, past that its two-launch planes form (``forward_form``); the tile form
and the planes form are also kept to hold the others against
(``_forward_cuda``).  Both keep the TPU kernels' answer
for ids outside the table (they add nothing) and for selectors outside
1..n_dist-1 (triple 0), so no check syncs the device.

The kernels run at every geometry the JAX package runs (any fpb >= 2, any
power-of-two pad_len), each from a library built for the operands' (fpb,
pad_len) (``kernels/build``).  ``geometry_forms`` says which forms a
geometry's library has (the tuned layouts fit some geometries only; launch
A's planes form and launch B take every one, launch A's ring form every
one past Q 16); ``pick_form`` and
``forward_form`` choose among those, and a form a geometry lacks, named
through ``_cuda``, raises.  ``check_geometry`` refuses only what no form can
supply (``card_refusal``).  Rows 1-6 need a history
of whole blocks (launch A); at a history of partial blocks the renderers
take row 7 on XD computed outside the kernels.
"""

from __future__ import annotations

import contextvars
import ctypes
import dataclasses
import functools

import torch

from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split, xfade_ramp
from . import build

# Compact-table bucket above which the JAX package leaves the one-hot form
# (a TPU VMEM gate: renderer.plan_onehot_chunking, batch._plan_batch_onehot).
# The CUDA step reads its table through L2 and has no such limit; the
# renderers keep the gate so they take the one-hot form exactly where the
# JAX package does.
MAX_ONEHOT_U = 256

# Most unique (u_hi, u_lo, inv_frac) triples of the compact-distance form;
# its triple operand has 8 rows.
MAX_DIST_UNIQ = 8

# Launches of each CUDA kernel since its count was last set to 0, keyed by
# wrapper; a wrapper's second form counts on its own ("/grouped" for row 2,
# "/no_xfade" for the no-crossfade forms of rows 5, 6 and 7; row 7's
# wrapper is kernels/fused_apply.fused_apply_xfade, row 8's
# kernels/fused_spatializer.fused_apply and .fused_forward_apply, rows
# 9-11's kernels/assoc_probe.prod, .mm and .mm_tree, row 12's
# kernels/dma_blend.dma_blend).
NO_XFADE = "fused_step_stream_xfade/no_xfade"
GROUPED = "fused_step_onehot_xfade/grouped"
SPATIALIZER = "fused_spatializer_apply"
launches: dict[str, int] = dict.fromkeys((
    "fused_step_onehot_xfade", GROUPED, "fused_step_stream_onehot_xfade",
    "fused_step_stream_onehot_grouped_xfade", "fused_step_stream_xfade", NO_XFADE,
    "fused_step_xfade", "fused_step_xfade/no_xfade",
    "fused_apply_xfade", "fused_apply_xfade/no_xfade", SPATIALIZER,
    "prod", "mm", "mm_tree", "dma_blend",
), 0)

# Launch B's forms on the card: one CTA per 32-row tile, or the split
# form, a cluster of CTAs per tile, one per 128-bin block of the
# blocked tail, folded in launch B's order (csrc/fused_forward.cuh): the
# same bits.  Row 1 sums one chain over K: launch B, or its staged form
# (csrc/fused_step_onehot.cu: each filter row blended once a tile from its
# distinct table rows staged in shared memory, by producer warps while
# consumer warps run the chains), the same bits.  Row 8 also has its
# few-row cluster form (kernels/fused_spatializer).
LAUNCH_B, SPLIT, STAGED = "launch_b", "split", "staged"
_FORM_CODE = {LAUNCH_B: 0, SPLIT: 1, STAGED: 2}
ROW1 = "fused_step_onehot_xfade"

# Row 8's launches by form, within its one count above: the cluster form
# (few rows), launch B or the split form.
spatializer_forms: dict[str, int] = dict.fromkeys(("cluster", LAUNCH_B, SPLIT), 0)

# The launches of rows 2-7 that took the split form, within each kernel's
# count above.
split_launches: dict[str, int] = dict.fromkeys((
    GROUPED, "fused_step_stream_onehot_xfade", "fused_step_stream_onehot_grouped_xfade",
    "fused_step_stream_xfade", NO_XFADE, "fused_step_xfade", "fused_step_xfade/no_xfade",
    "fused_apply_xfade", "fused_apply_xfade/no_xfade",
), 0)

# Rows from which rows 2-7 take the split form on the card: on an H100
# (700 W) it took less device time alone than launch B for each of them at
# every count of 8-16,384 rows (chip_smoke.py's crossover, phase bench;
# PERF.md, the kernel table).  At the other geometries, see LAUNCH_B_SPANS.
SPLIT_FROM = 1

# The kernels of rows 2-8 that blend their filter rows (rows 2-4 and 8);
# rows 5-7 take theirs pre-blended (PRE_BLENDED: their crossfade forms, the
# kind LAUNCH_B_SPANS names "pre-blended").
BLENDED = (GROUPED, "fused_step_stream_onehot_xfade", "fused_step_stream_onehot_grouped_xfade",
           SPATIALIZER)
PRE_BLENDED = ("fused_step_stream_xfade", "fused_step_xfade", "fused_apply_xfade")

# Away from fpb 128 / pad 1024: the row counts, first to last, at which
# launch B took less device time alone than the split form by more than a
# reading's spread between chip runs, by geometry and kind of row
# ("blended": rows 2-4, "pre-blended": rows 5-7 with the crossfade
# (PRE_BLENDED), "row 8"); at every other count of the crossover (8, 64,
# 256, 512, 1,024, 2,048, 3,072, 4,096, 6,144, 8,192, 16,384 rows; rows 5-7
# at 8, 512, 2,048, 4,096, 16,384) the split form took less or the two were
# within that spread, and so the split form is taken there and at the
# counts between (an H100, 700 W; scripts/split_layouts.py, two readings in
# turns; PERF.md, the kernel table).  From fpb 128 up (and at fpb 100)
# launch B wins where its grid of ceil(rows / 32) x T_TILES CTAs is one
# whole wave of 128 (and at f441 up to four at PR 17, two since PR 20), launch B / split ms: rows 2
# / 3 / 4 at f512 1,024 rows 0.2714 / 0.3100, 0.2725 / 0.3101, 0.2740 /
# 0.3107; f1024 512 rows 0.5415 / 0.5808, 0.5346 / 0.5801, 0.5263 /
# 0.5795; f2048 256 rows 1.0756 / 1.1448, 1.0750 / 1.1511, 1.0766 /
# 1.1438; row 8 at f100 4,096 rows 0.1980 / 0.2464; f256 2,048 rows 0.2007
# / 0.2390; f512 1,024 0.2006 / 0.2518; f1024 512 0.4003 / 0.4566; f2048
# 256 0.8269 / 0.9040; f441 1,024 0.2014 / 0.3205 to 4,096 0.8098 / 0.8752
# (PR 17).  Where the tile fits the block (fpb 64, 16, 4: launch B's CTAs
# of 16 rows) row 8 takes launch B from 3,072 rows (f4 6,144), launch B /
# split ms at 4,096 rows f64 0.1328 / 0.1871, f64t256 0.0752 / 0.0880, f16
# 0.0969 / 0.1250, at 16,384 f4 0.1854 / 0.3068; rows 3 and 4 at f64
# 6,144-8,192 rows (0.2213 /
# 0.2410 to 0.2964 / 0.3154), rows 2-4 at f64t256 8,192 (0.1482 / 0.1742),
# rows 2 and 4 and rows 5 and 7 at f16 16,384 (0.6016 / 0.6362, 0.1589 /
# 0.1930), row 7 at f4 16,384 (0.1214 / 0.1307) (PR 18).
# Read again with the pipelined layout past one t-tile (PR 20), the same
# spans but at f441: rows 2 / 3 / 4 / 8 at f512 1,024 rows 0.2721 /
# 0.3242, 0.2724 / 0.3261, 0.2772 / 0.3257, 0.2016 / 0.2676; f1024 512
# rows 0.5427 / 0.6092, 0.5361 / 0.6111, 0.5312 / 0.6114, 0.4094 /
# 0.4898; f2048 256 rows 1.0737 / 1.1941, 1.0772 / 1.2046, 1.0745 /
# 1.1923, 0.8297 / 0.9609; row 8 at f256 2,048 rows 0.2017 / 0.2417;
# rows 5-7 at f2048 took the split form at 8 to 4,096 rows.  Row 8 at f441
# keeps launch B at 1,024 rows 0.2022 / 0.3185 and 2,048 0.3983 / 0.4773,
# and no longer at 3,072 (0.6233 / 0.6390) and 4,096 (0.8087 / 0.8047),
# within the spread.
LAUNCH_B_SPANS: dict[tuple[int, int], dict[str, tuple[int, int]]] = {
    (4, 1024): {"pre-blended": (16384, 16384), "row 8": (6144, 16384)},
    (16, 1024): {"blended": (16384, 16384), "pre-blended": (16384, 16384),
                 "row 8": (3072, 16384)},
    (64, 512): {"blended": (8192, 8192), "row 8": (3072, 16384)},
    (64, 1024): {"blended": (6144, 8192), "row 8": (3072, 16384)},
    (100, 1024): {"row 8": (4096, 4096)},
    (256, 1024): {"row 8": (2048, 2048)},
    (441, 1024): {"row 8": (1024, 2048)},
    (512, 1024): {"blended": (1024, 1024), "row 8": (1024, 1024)},
    (1024, 2048): {"blended": (512, 512), "row 8": (512, 512)},
    (2048, 4096): {"blended": (256, 256), "row 8": (256, 256)},
}

# Rows from which row 1 takes launch B's staged form on the card: on an
# H100 (700 W) it took less device time alone than the one-CTA form at
# 16,384 and 32,768 rows, more at 1,024-12,288 (chip_smoke.py's crossover,
# phase bench; PERF.md, the kernel table).
STAGED_FROM = 16384

# Row 1's launches by form, within its count above.
row1_forms: dict[str, int] = dict.fromkeys((LAUNCH_B, STAGED), 0)

# Launch A's forms on the card, the same bits (csrc/fused_forward.cuh): the
# tile form (one CTA per 32 blocks x 64 bins of a source), kept to hold the
# others against; the product form (64 flat sub-block rows x 64 bins a
# CTA); the few-block form (a thread per bin and plane, every row of its
# source), which the steps take up to FEW_NB blocks a source; the ring
# form (one launch: a CTA per run of one source's blocks and 32 bins, its
# sub-block DFTs built into a shared-memory ring as m advances), which the
# steps take past Q 16 where the product form does not exist and the ring
# form pays (``ring_pays``); and the planes form (each sub-block's DFT
# written once to a scratch, then the twiddle sum per output and bin
# through L2, two launches), which takes any Q, is taken where the ring
# form does not pay, and holds the ring form to its bits.
FWD_TILE, FWD_PRODUCT, FWD_FEW, FWD_PLANES, FWD_RING = "tile", "product", "few", "planes", "ring"
_FWD_CODE = {FWD_TILE: 0, FWD_PRODUCT: 1, FWD_FEW: 2, FWD_PLANES: 3, FWD_RING: 4}
# The planes form's two launches alone, to time each apart: the sub-block
# DFTs into the scratch, and the twiddle sums and distance multiply from it.
PLANES_DFT, PLANES_SUM = "dft", "sum"
_PLANES_PART_CODE = {PLANES_DFT: 5, PLANES_SUM: 6}

# Most blocks a source at which the steps take launch A's few-block form
# at fpb 128 / pad 1024 (csrc/fused_forward.cuh FEW_NB; its kernel carries
# nb + 7 <= 16 rows a thread): on an H100 (700 W) it took less device time
# alone than the product form at every count of 1-9 blocks (chip_smoke.py,
# phase bench).  Other geometries: ``geometry_forms(fpb, pad).few_nb``.
FEW_NB = 9

# Launch A's launches by form: one per launch of rows 1-6, of row 8's
# forward form and of ``_forward_cuda``.
forward_launches: dict[str, int] = dict.fromkeys(_FWD_CODE, 0)

# Row 12's forms on the card, the same bits (csrc/dma_blend.cu): the
# double-buffered form (8 rows x 1,024 columns a CTA) and the dedup form
# (32 rows a CTA, each distinct table row staged once a column slice);
# its launches by form, within its one count ``launches["dma_blend"]``
# (kernels/dma_blend takes the dedup form).
DOUBLE, DEDUP = "double", "dedup"
blend_forms: dict[str, int] = dict.fromkeys((DOUBLE, DEDUP), 0)

# The form a card test or chip_smoke.py names through ``_cuda``; None: pick.
_named_form: contextvars.ContextVar[str | None] = contextvars.ContextVar("form", default=None)

# Launch B's split form exists where the blocked tail is 1 to
# SPLIT_MAX_BLOCKS whole 128-bin blocks and fpb % 4 == 0 or fpb > 128
# (csrc/fused_forward.cuh HAS_SPLIT), in one of two layouts with the same
# bits, fixed when the library is built (``split_default``; the library
# reports its own, ``Forms.layouts``): chunked (a CTA per t-tile and block,
# q built a 32-bin chunk at a time) or pipelined (a CTA per block, q built
# once, the t-tiles one stream of basis chunks through a ring, the fold by
# warps of its own while the next t-tile is multiplied).  Their codes in
# the library's report (SplitLayout).
SPLIT_MAX_BLOCKS = 16
SPLIT_CHUNKED, SPLIT_PIPE = "chunked", "pipelined"
_LAYOUT_CODE = {"": 0, SPLIT_CHUNKED: 1, SPLIT_PIPE: 2}

# Launch B's output columns a CTA (csrc/fused_forward.cuh TT): its t-tiles
# lie along the grid's y, which holds at most GRID_Y CTAs.  Below T_TILE a
# block size that divides it fits the tile (``Forms.tile_cols``).
T_TILE, GRID_Y = 128, 65535

# Launch A's tile form takes Q <= 16 (its twiddles in registers, its
# 32 + Q - 1 sub-block rows in shared memory), its product form Q <= 64
# (a tile's output starts stay most of its rows); past Q 16 the ring form
# exists, and the steps take it where the product form does not and it
# pays (csrc/fused_forward.cuh TILE_MAX_Q, PRODUCT_MAX_Q, HAS_RING, ring_pays).
TILE_MAX_Q, PRODUCT_MAX_Q = 16, 64


@dataclasses.dataclass(frozen=True)
class Forms:
    """The forms a geometry's library has (csrc/fused_forward.cuh's HAS_*
    and FEW_NB; ``jt_geometry`` reports the library's own).  Launch A's
    planes form and launch B exist at every geometry, launch A's ring form
    at every history of whole blocks past Q 16 (``ring``)."""

    fpb: int
    pad: int
    bins: int
    q: int          # sub-blocks a window; 0 for a history of partial blocks (no launch A)
    few_nb: int     # launch A's few-block form up to this many blocks a source
    product: bool   # launch A's product form
    split: bool     # launch B's split form (rows 2-8)
    staged: bool    # row 1's staged launch B
    cluster: bool   # row 8's cluster form
    tile: bool      # launch A's tile form
    tile_cols: int  # columns of launch B's and the chunked layout's tile (csrc T_COLS)
    layouts: tuple[str, str] = ("", "")  # the split form's layout: blended, pre-blended rows

    @property
    def ring(self) -> bool:
        """Launch A's ring form: where the tile form does not exist (csrc
        HAS_RING)."""
        return self.q > TILE_MAX_Q


@functools.cache
def geometry_forms(fpb: int, pad_len: int) -> Forms:
    """The forms of the (fpb, pad_len) library, by the sources' rules:
    launch A where the history is whole blocks (its tile form to Q 16, its
    product form with 64-bin slices from pad 128 to Q 64, its few-block form
    where its static shared memory stays under 48 KB, its planes form
    always), launch B's split form where the tail is 1 to 16 whole 128-bin
    blocks and fpb % 4 == 0 or fpb > 128, row 1's
    staged form and row 8's cluster form at fpb 128 / pad 1024 alone; a
    tile of fpb columns for launch B and the split form's chunked layout
    where fpb divides 128 below it (64, 32, ..., 2), else of 128."""
    bins = pad_len // 2 + 1
    aligned = pad_len % fpb == 0
    q = pad_len // fpb if aligned else 0

    def few_fits(r: int) -> bool:
        return aligned and q <= r and 4 * fpb * (r + 32) < 48 * 1024

    few_nb = 17 - q if few_fits(16) else 9 - q if few_fits(8) else 0
    tuned = (fpb, pad_len) == (128, 1024)
    split = ((bins - 1) % 128 == 0 and 1 <= (bins - 1) // 128 <= SPLIT_MAX_BLOCKS
             and (fpb % 4 == 0 or fpb > T_TILE))
    return Forms(
        fpb=fpb, pad=pad_len, bins=bins, q=q, few_nb=few_nb,
        product=(aligned and bins - 1 >= 64 and (bins - 1) % 64 == 0 and fpb % 32 == 0
                 and q <= PRODUCT_MAX_Q),
        split=split, staged=tuned, cluster=tuned, tile=aligned and q <= TILE_MAX_Q,
        tile_cols=fpb if fpb < T_TILE and T_TILE % fpb == 0 else T_TILE,
        layouts=((split_default(SPATIALIZER, fpb), split_default(PRE_BLENDED[0], fpb)) if split
                 else ("", "")),
    )


# The t-tiles of 128 columns from which pre-blended rows (rows 5-7) take
# the split form's pipelined layout, where it took less device time alone
# than the chunked one on an H100 (PERF.md, the pipelined layout;
# csrc/fused_forward.cuh PIPE_PRE_BLENDED_TILES).
PIPE_PRE_BLENDED_TILES = 16


def split_default(name: str, fpb: int) -> str:
    """The layout the split form takes for kernel ``name`` (rows 2-8; csrc/
    fused_forward.cuh split_layout), by its kind of row and the t-tiles of
    128 columns: pipelined past one t-tile for blended rows (rows 2-4 and 8)
    and from ``PIPE_PRE_BLENDED_TILES`` for pre-blended rows, else
    chunked."""
    t_tiles = -(-fpb // T_TILE)
    if t_tiles > 1 and (name in BLENDED or t_tiles >= PIPE_PRE_BLENDED_TILES):
        return SPLIT_PIPE
    return SPLIT_CHUNKED


def card_refusal(fpb: int, pad_len: int) -> str | None:
    """Why the card cannot run the (fpb, pad_len) geometry, naming the
    resource no form supplies, or None.  Launch A's planes form takes any
    whole-block history and launch B any geometry (a history of partial
    blocks needs no launch A: the apply-only steps run there); what is left
    is the grid's y, which holds launch B's t-tiles of 128 columns."""
    if pad_len < fpb or pad_len & (pad_len - 1):
        return f"pad {pad_len} is not a power of two >= fpb {fpb}"
    t_tiles = -(-fpb // T_TILE)
    if t_tiles > GRID_Y:
        return (f"launch B's {t_tiles} t-tiles of {T_TILE} columns exceed the {GRID_Y} CTAs a "
                f"grid's y holds")
    return None


def check_geometry(fpb: int, pad_len: int, what: str = "the CUDA step",
                   remedy: str | None = None) -> None:
    """Raise a ValueError naming the geometry, the resource (``card_refusal``)
    and ``remedy`` unless the card's kernels take fpb and pad_len."""
    why = card_refusal(fpb, pad_len)
    if why is not None:
        raise ValueError(f"{what} on a CUDA device: fpb {fpb}, pad {pad_len}: {why}"
                         + (f"; {remedy}" if remedy else ""))


def reset_launches() -> None:
    """Set every kernel's launch count, and the counts by form, to 0."""
    for counts in (launches, spatializer_forms, split_launches, forward_launches, blend_forms,
                   row1_forms):
        for name in counts:
            counts[name] = 0


def launch_b_span(kind: str, rows: int, fpb: int, pad_len: int) -> bool:
    """Whether ``rows`` lies in LAUNCH_B_SPANS' span for rows of ``kind`` at
    (fpb, pad_len)."""
    first, last = LAUNCH_B_SPANS.get((fpb, pad_len), {}).get(kind, (0, -1))
    return first <= rows <= last


def pick_form(name: str, rows: int, fpb: int = 128, pad_len: int = 1024) -> str:
    """Launch B's form on the card for kernel ``name`` (rows 1-7) at ``rows``
    rows, among those of the (fpb, pad_len) library."""
    forms = geometry_forms(fpb, pad_len)
    if name == ROW1:
        return STAGED if rows >= STAGED_FROM and forms.staged else LAUNCH_B
    if name not in split_launches or rows < SPLIT_FROM or not forms.split:
        return LAUNCH_B
    kind = "blended" if name in BLENDED else "pre-blended" if name in PRE_BLENDED else None
    return LAUNCH_B if kind and launch_b_span(kind, rows, fpb, pad_len) else SPLIT


# Launch A's ring form took less device time alone than the planes form at
# every shape timed up to fpb 32, by more than a reading's spread
# (RUN_SPREAD), so the steps take it there: ring / planes ms, fpb
# 16 at 16 x 256 0.0733 / 0.1186, 16 x 64 0.0227 / 0.0477, 1 x 2,048
# 0.0375 / 0.0537, 1 x 1 0.0089 / 0.0257; fpb 4 0.1964 / 0.5067, 0.0601 /
# 0.3017, 0.1036 / 0.1519, 0.0194 / 0.0801 (an H100, 700 W;
# scripts/tail_times.py, the parent's tree and this one in turns); fpb 2
# 0.3639 / 1.3251, 0.1124 / 1.0108, 0.1876 / 0.2891, 0.0337 / 0.1493; fpb
# 32 under pad 4096 0.5264 / 0.7491, 0.1635 / 0.3831, 0.2693 / 0.3268,
# 0.0193 / 0.0445 (the same card, the shape ring_shape picks).  Past fpb
# 32 its sub-block DFTs, built again for each run's halo rows, grow with
# fpb, while the planes form loses only its sums that straddle two
# sources, (S - 1)(Q - 1) of them: at one source the planes form won.  The
# same shapes, ring / planes ms (scripts/tail_times.py --launch-a-forms;
# the same card):
# fpb 64 under pad 8192 (Q 128) 1.3113 / 1.5594, 0.4064 / 0.7759, 0.6669
# / 0.5954, 0.0293 / 0.0507; fpb 64 under pad 16384 (Q 256) 4.4314 /
# 7.9023, 1.4267 / 4.7949, 2.2599 / 2.1831, 0.1143 / 0.1632; fpb 128 under
# pad 16384 (Q 128) 3.7229 / 3.7381, 1.1634 / 1.8158, 1.9094 / 1.3849,
# 0.0955 / 0.0711; fpb 128 under pad 32768 (Q 256) 12.3229 / 17.6079,
# 4.0205 / 10.6559, 6.2213 / 4.7721, 0.3118 / 0.2537; fpb 256 under pad
# 32768 (Q 128) 12.5574 / 10.7793, 4.4599 / 5.2719, 6.3556 / 3.8689,
# 0.3408 / 0.1934; fpb 512 under pad 65536 (Q 128) 51.8824 / 30.8404,
# 16.4849 / 15.0841, 26.0050 / 10.9435, 1.1297 / 0.5981.  So past fpb 32
# the steps take the ring form where fpb <= Q and the straddling sums are
# at least half the outputs (``ring_pays``): every shape it picks there
# won by more than RUN_SPREAD, and it picks none where the ring form lost
# or tied; it leaves three wins to the planes form (fpb 64 under pad 8192
# at 16 x 256, fpb 64 at 1 x 1, fpb 256 at 16 x 64), each beside a loss
# of the same S and nb or the same fpb that a rule this simple would take
# with it (csrc/fused_forward.cuh ring_pays; PERF.md, the ring form).
RING_MAX_FPB = 32


def ring_pays(sources: int, nb: int, fpb: int, pad_len: int) -> bool:
    """Whether the steps take launch A's ring form at ``sources`` x ``nb``
    blocks where the (fpb, pad_len) library has it (csrc/fused_forward.cuh
    ring_pays): up to RING_MAX_FPB always; past it where fpb <= Q and the
    planes form's (S - 1)(Q - 1) sums that straddle two sources are at
    least half of its S nb outputs."""
    q = pad_len // fpb
    return fpb <= RING_MAX_FPB or (fpb <= q and 2 * (sources - 1) * (q - 1) >= sources * nb)


def forward_form(nb: int, fpb: int = 128, pad_len: int = 1024, sources: int = 1) -> str:
    """Launch A's form on the card at ``sources`` x ``nb`` blocks (the
    steps' choice, csrc/fused_forward.cuh forward_form): the few-block form
    up to the geometry's ``few_nb``, else its product form, else its tile
    form, else the ring form where it pays (``ring_pays``), else the planes
    form."""
    forms = geometry_forms(fpb, pad_len)
    if nb <= forms.few_nb:
        return FWD_FEW
    if forms.product or forms.tile:
        return FWD_PRODUCT if forms.product else FWD_TILE
    return FWD_RING if forms.ring and ring_pays(sources, nb, fpb, pad_len) else FWD_PLANES


def planes_scratch(n_src: int, nb: int, fpb: int, pad_len: int, device):
    """The planes form's scratch (pr, pi: the n_src * (nb + q - 1) sub-block
    DFTs x bins each) where launch A takes that form at ``nb`` blocks a
    source, else (None, None)."""
    if forward_form(nb, fpb, pad_len, n_src) != FWD_PLANES:
        return None, None
    shape = (n_src * (nb + pad_len // fpb - 1), pad_len // 2 + 1)
    return tuple(torch.empty(shape, dtype=torch.float32, device=device) for _ in range(2))


def _cuda(fn, *args, form: str, **kwargs):
    """``fn(*args, **kwargs)``, a wrapper of rows 1-7, with launch B in
    ``form`` on the card (the card tests and chip_smoke.py hold the forms
    against each other this way; the wrappers pick by ``pick_form``)."""
    if form not in _FORM_CODE:
        raise ValueError(f"form {form!r}: want 'launch_b' or 'split', or 'staged' for row 1")
    token = _named_form.set(form)
    try:
        return fn(*args, **kwargs)
    finally:
        _named_form.reset(token)


def _form(name: str, rows: int, fpb: int = 128, pad_len: int = 1024) -> str:
    """The form this launch of ``name`` takes: the one named through
    ``_cuda``, else ``pick_form``; the split form is the blocked tail's,
    the staged form row 1's, and a form the geometry's library lacks
    raises."""
    form = _named_form.get() or pick_form(name, rows, fpb, pad_len)
    if form == SPLIT and name not in split_launches:
        raise ValueError(f"{name} sums one chain over K: launch B only, in its one-CTA or "
                         f"staged form")
    if form == STAGED and name != ROW1:
        raise ValueError(f"the staged form is row 1's, not {name}'s")
    forms = geometry_forms(fpb, pad_len)
    if (form == SPLIT and not forms.split) or (form == STAGED and not forms.staged):
        raise ValueError(f"the {form} form does not exist at fpb {fpb}, pad {pad_len}")
    return form


def _count(name: str, form: str) -> None:
    launches[name] += 1
    if form == SPLIT:
        split_launches[name] += 1
    if name == ROW1:
        row1_forms[form] += 1


# ---- plain-PyTorch twins, in the JAX package's op order ---------------------

def blend_cat(table, indices, weights):
    """Weighted 4-row gather on a combined table -> (rows, 4*bins), summed in
    bracket order, as the CUDA step blends (the renderer's ``blend_cat``)."""
    w = weights.to(torch.float32)
    idx = indices.long()
    acc = w[:, 0:1] * table[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + w[:, j : j + 1] * table[idx[:, j]]
    return acc


def _in_table(idx, w, u: int, base=0):
    """An id outside the table (its group's ``u`` rows) matches no one-hot
    column of the TPU blend, so it contributes nothing: weight 0 on row 0.
    ``base``: each row's group offset into a stacked table."""
    ok = (idx >= 0) & (idx < u)
    return torch.where(ok, idx + base, 0), torch.where(ok, w, 0.0)


def _forward_reference(streams, nb, uh, ul, fr, dsel, n_dist, *, pad_len, bins, fpb):
    """XD = X * D for the S*nb rows of S streams: the sliding forward DFT
    times the distance planes (per row, or each row's selected triple)."""
    rows = streams.shape[0] * nb
    xr, xi = fft_ops.rfft_sliding_split_batched(streams, nb, fpb, pad_len)
    xr, xi = xr.reshape(rows, bins), xi.reshape(rows, bins)
    dr, di = distance_factors_split(uh[:, 0], ul[:, 0], fr[:, 0], bins)
    if n_dist is not None:  # each row takes the planes of its own triple
        sel = dsel[:, 0].long()
        # a selector outside 1..n_dist-1 takes triple 0, as on the TPU
        sel = torch.where((sel > 0) & (sel < n_dist), sel, 0)
        dr, di = dr[sel], di[sel]
    return cmul(xr, xi, dr, di)


def _tails_reference(xdr, xdi, g_old, g_new, xf, *, pad_len, bins, fpb, bases=None):
    """Per-ear tail IDFTs of XD * G and the crossfade -> (rows, 2*fpb);
    ``g_old=None`` computes the new side only (the no-crossfade form).
    ``bases``: the (bins, fpb) tail-IDFT planes, default those of pad_len."""
    icr, ici = bases or fft_ops.on_device(fft_ops._idft_tail_matrices, pad_len, fpb,
                                          device=xdr.device)

    def tail(g, ear):
        gr = g[:, 2 * ear * bins : (2 * ear + 1) * bins]
        gi = g[:, (2 * ear + 1) * bins : (2 * ear + 2) * bins]
        qr, qi = cmul(xdr, xdi, gr, gi)
        return qr @ icr + qi @ ici

    if g_old is None:
        return torch.cat([tail(g_new, e) for e in range(2)], dim=1)
    fn = xfade_ramp(fpb, xdr.device)
    on = xf > 0
    a = torch.where(on, 1.0 - fn, 0.0)
    b = torch.where(on, fn, 1.0)
    return torch.cat([tail(g_old, e) * a + tail(g_new, e) * b for e in range(2)], dim=1)


def _onehot_reference(streams, nb, uh, ul, fr, table, ridx, w, bnd_idx, bnd_w, xf, *,
                      seg, group_rows, u_rows, pad_len, bins, fpb, dsel, n_dist):
    """The one-hot step over S streams of nb blocks: old rows blend from
    the table group of their row; the new row of r is old row r+1 inside a
    segment of ``seg`` rows and the blend of bnd[r // seg] at its end."""
    xdr, xdi = _forward_reference(streams, nb, uh, ul, fr, dsel, n_dist,
                                  pad_len=pad_len, bins=bins, fpb=fpb)
    rows = ridx.shape[0]
    n_seg = rows // seg
    dev = ridx.device
    base = (torch.arange(rows, device=dev) // group_rows * u_rows)[:, None]
    g_old = blend_cat(table, *_in_table(ridx, w, u_rows, base))
    bbase = (torch.arange(n_seg, device=dev) * seg // group_rows * u_rows)[:, None]
    g_bnd = blend_cat(table, *_in_table(bnd_idx, bnd_w, u_rows, bbase))
    g_new = torch.cat([g_old.reshape(n_seg, seg, -1)[:, 1:], g_bnd[:, None]], dim=1)
    return _tails_reference(xdr, xdi, g_old, g_new.reshape(rows, -1), xf,
                            pad_len=pad_len, bins=bins, fpb=fpb)


def _table_groups(rows: int, nb: int, table_rows: int, tb, group_tiles) -> tuple[int, int]:
    """(group_rows, u_rows) of the batched one-hot step: one shared table,
    or groups of ``group_tiles`` tiles of ``tb`` rows, each with its own
    slice of ``table_rows // n_groups`` table rows."""
    if group_tiles is None:
        return rows, table_rows
    if tb is None or tb < 1 or tb % nb or rows % tb or (rows // tb) % group_tiles:
        raise ValueError(f"{rows} rows do not split into groups of {group_tiles} tiles of "
                         f"{tb} rows that own whole sources of {nb} blocks")
    n_groups = rows // tb // group_tiles
    if table_rows % n_groups:
        raise ValueError(f"table of {table_rows} rows does not split into {n_groups} groups")
    return tb * group_tiles, table_rows // n_groups


def fused_step_onehot_xfade_reference(
    streams, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf,
    *, nb: int, pad_len: int, bins: int, fpb: int, tb: int | None = None,
    group_tiles: int | None = None, dsel=None, n_dist=None,
):
    """Plain-PyTorch twin of rows 1 and 2 (see fused_step_onehot_xfade)."""
    group_rows, u_rows = _table_groups(ridx.shape[0], nb, table.shape[0], tb, group_tiles)
    return _onehot_reference(
        streams, nb, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf,
        seg=nb, group_rows=group_rows, u_rows=u_rows,
        pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist,
    )


def fused_step_stream_onehot_xfade_reference(
    stream, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf,
    *, pad_len: int, bins: int, fpb: int, dsel=None, n_dist=None,
):
    """Plain-PyTorch twin of row 3 (see fused_step_stream_onehot_xfade)."""
    b = ridx.shape[0]
    return _onehot_reference(
        stream[None], b, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf,
        seg=b, group_rows=b, u_rows=table.shape[0],
        pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist,
    )


def fused_step_stream_onehot_grouped_xfade_reference(
    stream, uh, ul, fr, tables, ridx, w, rbnd, wbnd, xf,
    *, pad_len: int, bins: int, fpb: int, tb: int, group_tiles: int, u_pad: int,
    dsel=None, n_dist=None,
):
    """Plain-PyTorch twin of row 4 (see fused_step_stream_onehot_grouped_xfade)."""
    return _onehot_reference(
        stream[None], ridx.shape[0], uh, ul, fr, tables, ridx, w, rbnd, wbnd, xf,
        seg=tb, group_rows=tb * group_tiles, u_rows=u_pad,
        pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist,
    )


def _gather_reference(streams, nb, uh, ul, fr, g_rows, g_last, xf, *, with_xfade,
                      pad_len, bins, fpb, dsel, n_dist):
    """The gather-form step over S streams of nb blocks: the new row of r
    is g_rows[r+1] inside a source and g_last[s] at its last row; without
    the crossfade g_rows are the new rows and only their side is computed."""
    xdr, xdi = _forward_reference(streams, nb, uh, ul, fr, dsel, n_dist,
                                  pad_len=pad_len, bins=bins, fpb=fpb)
    kw = dict(pad_len=pad_len, bins=bins, fpb=fpb)
    if not with_xfade:
        return _tails_reference(xdr, xdi, None, g_rows, None, **kw)
    s = streams.shape[0]
    g_new = torch.cat([g_rows.reshape(s, nb, -1)[:, 1:], g_last[:, None]], dim=1)
    return _tails_reference(xdr, xdi, g_rows, g_new.reshape(s * nb, -1), xf, **kw)


def fused_step_stream_xfade_reference(
    stream, uh, ul, fr, g_old, g_last, xf,
    *, pad_len: int, bins: int, fpb: int, dsel=None, n_dist=None, with_xfade: bool = True,
):
    """Plain-PyTorch twin of row 5 (see fused_step_stream_xfade)."""
    return _gather_reference(
        stream[None], g_old.shape[0], uh, ul, fr, g_old, g_last, xf, with_xfade=with_xfade,
        pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist,
    )


def fused_step_xfade_reference(
    streams, uh, ul, fr, g_old, g_last, xf,
    *, nb: int, pad_len: int, bins: int, fpb: int, dsel=None, n_dist=None,
    with_xfade: bool = True,
):
    """Plain-PyTorch twin of row 6 (see fused_step_xfade)."""
    return _gather_reference(
        streams, nb, uh, ul, fr, g_old, g_last, xf, with_xfade=with_xfade,
        pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist,
    )


# ---- the CUDA side -----------------------------------------------------------

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_DIST_ARGS = [_ptr, _ptr, _ptr, _ptr, _int]           # uh, ul, fr, dsel, n_dist
_BASES_ARGS = [_ptr] * 6                              # cfr, cfi, twr, twi, icr, ici


@functools.cache
def _entry(lib: str, symbol: str, middle: tuple, geometry: tuple[int, int]):
    fn = getattr(build.load(lib, geometry=geometry), symbol)
    fn.argtypes = [_int, _ptr, _ptr, _int, _int,      # device, stream, streams, sources, nb
                   *_DIST_ARGS, *middle, *_BASES_ARGS,
                   _ptr, _ptr, _ptr, _ptr, _ptr]      # xdr, xdi, pr, pi scratch, out
    fn.restype = _int
    return fn


def _onehot_entry(geometry):
    # table, its rows per group, ridx, w, bnd_idx, bnd_w, seg, group_rows,
    # blocked_tail, form, xf
    return _entry("fused_step_onehot", "jt_fused_step_onehot_xfade",
                  (_ptr, _int, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr), geometry)


def _gather_entry(geometry):
    # g_rows, g_last, xf, with_xfade, form
    return _entry("fused_step_gather", "jt_fused_step_gather_xfade",
                  (_ptr, _ptr, _ptr, _int, _int), geometry)


def library_geometry(lib: str, fpb: int, pad_len: int) -> Forms:
    """What the (fpb, pad_len) library of ``lib`` reports of itself
    (``jt_geometry``), as ``Forms``: the card tests and chip_smoke.py hold
    ``geometry_forms`` to it."""
    fn = build.load(lib, geometry=(fpb, pad_len)).jt_geometry
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 13)()
    fn(out)
    v = list(out)
    names = {code: name for name, code in _LAYOUT_CODE.items()}
    return Forms(fpb=v[0], pad=v[1], bins=v[2], q=v[3], few_nb=v[4], product=bool(v[5]),
                 split=bool(v[6]), staged=bool(v[7]), cluster=bool(v[8]), tile=bool(v[9]),
                 tile_cols=v[10], layouts=(names[v[11]], names[v[12]]))


def split_occupancy(lib: str, fpb: int, pad_len: int, sides: int = 2, device: int = 0) -> dict:
    """How the card holds the split form of the (fpb, pad_len) library of
    ``lib`` (``fused_step_onehot``: blended rows; ``fused_step_gather``:
    pre-blended rows) at ``sides`` sides, in the layout that library takes:
    {"layout", "clusters" (cudaOccupancyMaxActiveClusters), "ranks" (CTAs a
    cluster), "ctas_per_sm", "sms" (the SMs those clusters cover),
    "threads", "smem"}.  Raises where the library has no split form."""
    fn = build.load(lib, geometry=(fpb, pad_len)).jt_split_occupancy
    fn.argtypes = [_int, _int, _int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _int
    out = (ctypes.c_int * 5)()
    err = fn(device, int(lib == "fused_step_onehot"), sides, out)
    if err:
        raise RuntimeError(f"{lib} at fpb {fpb}, pad {pad_len}: the split form's occupancy: "
                           f"{_cuda_error(lib, err, (fpb, pad_len))}")
    clusters, ranks, per_sm, threads, smem = list(out)
    layout = library_geometry(lib, fpb, pad_len).layouts[lib != "fused_step_onehot"]
    return {"layout": layout, "clusters": clusters, "ranks": ranks, "ctas_per_sm": per_sm,
            "sms": -(-clusters * ranks // max(per_sm, 1)), "threads": threads, "smem": smem}


def _cuda_error(lib: str, code: int, geometry=None) -> str:
    fn = build.load(lib, geometry=geometry).jt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _one_device(operands) -> torch.device:
    """The one device every operand lies on; raises for mixed devices or a
    device with no kernel (neither the CPU's twin nor a CUDA kernel)."""
    device = operands[0].device
    if any(t.device != device for t in operands):
        raise ValueError("all operands must lie on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def _where(operands, pad_len: int, bins: int, fpb: int) -> torch.device:
    """``_one_device``; on CUDA the card must also take the geometry
    (``check_geometry``), with bins = pad_len/2 + 1."""
    device = _one_device(operands)
    if device.type == "cuda":
        check_geometry(fpb, pad_len)
        if bins != pad_len // 2 + 1:
            raise ValueError(f"bins {bins} is not pad_len/2 + 1 for pad_len {pad_len}")
    return device


def _whole_blocks(fpb: int, pad_len: int) -> None:
    """Launch A runs the sliding forward, which needs a history of whole
    blocks."""
    if pad_len % fpb:
        raise ValueError(f"launch A needs a history of whole blocks: fpb {fpb} does not divide "
                         f"pad {pad_len} (compute XD and take the apply-only step)")


def _check(specs: dict) -> None:
    for name, (t, shape, dtype) in specs.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _distance_specs(uh, ul, fr, dsel, n_dist, rows: int) -> dict:
    """Shape checks of the distance operands: (rows, 1) per row, or (n, 1)
    triples with a (rows, 1) selector."""
    n_trip = rows if dsel is None else uh.shape[0]
    specs = {a: (t, (n_trip, 1), torch.float32) for a, t in (("uh", uh), ("ul", ul), ("fr", fr))}
    if dsel is not None:
        specs["dsel"] = (dsel, (rows, 1), torch.int32)
        if not 1 <= n_dist <= n_trip:
            raise ValueError(f"n_dist={n_dist} outside 1..{n_trip}")
    return specs


def _check_streams(streams, nb: int, pad_len: int, fpb: int) -> None:
    q = pad_len // fpb
    if streams.shape[-1] != nb * fpb + (q - 1) * fpb:
        raise ValueError(f"streams {tuple(streams.shape)} do not hold {nb} blocks + history")


def _launch(name: str, form: str, lib: str, entry, device, streams, n_src, nb, dist, middle,
            rows: int, pad_len: int, bins: int, fpb: int):
    """Allocate the scratch and output, launch ``entry`` (of the (fpb,
    pad_len) library) on the current stream with launch B in ``form``,
    count the launch, and return the (rows, 2*fpb) output."""
    _whole_blocks(fpb, pad_len)
    cfr, cfi = fft_ops.on_device(fft_ops._subblock_dft_matrices, pad_len, fpb, device=device)
    twr, twi = fft_ops.on_device(fft_ops._sliding_twiddles, pad_len, fpb, device=device)
    icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, pad_len, fpb, device=device)
    # The kernel runs after this returns; the scratch planes it still reads
    # are freed here, which is safe because the caching allocator hands
    # them out again only in order on this same stream.
    xdr = torch.empty((rows, bins), dtype=torch.float32, device=device)
    xdi = torch.empty_like(xdr)
    pr, pi = planes_scratch(n_src, nb, fpb, pad_len, device)
    out = torch.empty((rows, 2 * fpb), dtype=torch.float32, device=device)
    ptr = lambda t: t.data_ptr() if isinstance(t, torch.Tensor) else t
    uh, ul, fr, dsel, n_dist = dist
    err = entry(
        device.index, torch.cuda.current_stream(device).cuda_stream,
        ptr(streams), n_src, nb, ptr(uh), ptr(ul), ptr(fr), ptr(dsel), n_dist or 0,
        *(ptr(a) for a in middle),
        ptr(cfr), ptr(cfi), ptr(twr), ptr(twi), ptr(icr), ptr(ici),
        ptr(xdr), ptr(xdi), ptr(pr), ptr(pi), ptr(out),
    )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_cuda_error(lib, err, (fpb, pad_len))})")
    _count(name, form)
    forward_launches[forward_form(nb, fpb, pad_len, n_src)] += 1
    return out


@functools.cache
def _forward_entry(geometry: tuple[int, int]):
    fn = build.load("fused_step_onehot", geometry=geometry).jt_forward_distance
    fn.argtypes = [_int, _ptr, _int, _ptr, _int, _int,  # device, stream, form, streams, S, nb
                   *_DIST_ARGS, *_BASES_ARGS[:4],
                   _ptr, _ptr, _ptr, _ptr]              # ..., cfr..twi, xdr, xdi, pr, pi
    fn.restype = _int
    return fn


def _forward_cuda(streams, nb: int, uh, ul, fr, dsel, n_dist, *, form: str, pad_len: int,
                  bins: int, fpb: int, part: str | None = None, scratch=None):
    """Launch A alone on the card in ``form`` -> the (S*nb, bins) XD planes
    (xdr, xdi) of S streams, ``_forward_reference``'s function: the card
    tests and chip_smoke.py hold the forms against each other this way;
    counted in ``forward_launches``.  ``part`` runs one of the planes
    form's two launches alone on the caller's ``scratch`` (pr, pi):
    PLANES_DFT writes the sub-block DFTs there (the XD returned is not
    written), PLANES_SUM reads them (chip_smoke.py times each apart)."""
    if form not in _FWD_CODE:
        raise ValueError(f"form {form!r}: want one of {sorted(_FWD_CODE)}")
    if part is not None and (form != FWD_PLANES or part not in _PLANES_PART_CODE
                             or scratch is None):
        raise ValueError(f"part {part!r}: the planes form's {sorted(_PLANES_PART_CODE)}, with "
                         f"its scratch")
    forms = geometry_forms(fpb, pad_len)
    if form == FWD_FEW and nb > forms.few_nb:
        raise ValueError(f"the few-block form takes at most {forms.few_nb} blocks a source at "
                         f"fpb {fpb}, pad {pad_len}, not {nb}")
    if ((form == FWD_PRODUCT and not forms.product) or (form == FWD_TILE and not forms.tile)
            or (form == FWD_RING and not forms.ring)):
        raise ValueError(f"the {form} form does not exist at fpb {fpb}, pad {pad_len}")
    _whole_blocks(fpb, pad_len)
    _check_streams(streams, nb, pad_len, fpb)
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    device = _where([streams, uh, ul, fr] + ([] if dsel is None else [dsel]), pad_len, bins, fpb)
    if device.type != "cuda":
        raise ValueError(f"launch A's forms run on the card, not on {device}")
    rows = streams.shape[0] * nb
    _check({"streams": (streams, tuple(streams.shape), torch.float32),
            **_distance_specs(uh, ul, fr, dsel, n_dist, rows)})
    if rows < 1:
        raise ValueError("launch A needs a block")
    cfr, cfi = fft_ops.on_device(fft_ops._subblock_dft_matrices, pad_len, fpb, device=device)
    twr, twi = fft_ops.on_device(fft_ops._sliding_twiddles, pad_len, fpb, device=device)
    xdr = torch.empty((rows, bins), dtype=torch.float32, device=device)
    xdi = torch.empty_like(xdr)
    pr = pi = None
    if form == FWD_PLANES:
        shape = (streams.shape[0] * (nb + pad_len // fpb - 1), bins)
        pr, pi = scratch if part else (torch.empty(shape, dtype=torch.float32, device=device)
                                       for _ in range(2))
        _check({"pr": (pr, shape, torch.float32), "pi": (pi, shape, torch.float32)})
    ptr = lambda t: None if t is None else t.data_ptr()
    code = _PLANES_PART_CODE[part] if part else _FWD_CODE[form]
    err = _forward_entry((fpb, pad_len))(
        device.index, torch.cuda.current_stream(device).cuda_stream, code,
        ptr(streams), streams.shape[0], nb, ptr(uh), ptr(ul), ptr(fr), ptr(dsel), n_dist or 0,
        ptr(cfr), ptr(cfi), ptr(twr), ptr(twi), ptr(xdr), ptr(xdi), ptr(pr), ptr(pi))
    if err:
        what = f"{form}, {part}" if part else form
        raise RuntimeError(f"launch A ({what}) failed: CUDA error {err} "
                           f"({_cuda_error('fused_step_onehot', err, (fpb, pad_len))})")
    forward_launches[form] += 1
    return xdr, xdi


def _onehot_cuda(name, device, streams, nb, uh, ul, fr, dsel, n_dist, table, u_rows, ridx, w,
                 bnd_idx, bnd_w, seg, group_rows, xf, *, pad_len, bins, fpb):
    """Rows 1-4 on the card.  Rows 2-4 sum the tail IDFT by 128-bin blocks,
    in launch B or its split form; row 1 keeps the one chain over K it was
    measured with, in launch B or its staged form."""
    rows = ridx.shape[0]
    n_seg = rows // seg
    specs = {
        "streams": (streams, tuple(streams.shape), torch.float32),
        "table": (table, (table.shape[0], 4 * bins), torch.float32),
        "ridx": (ridx, (rows, 4), torch.int32), "w": (w, (rows, 4), torch.float32),
        "boundary ids": (bnd_idx, (n_seg, 4), torch.int32),
        "boundary weights": (bnd_w, (n_seg, 4), torch.float32),
        "xf": (xf, (rows, 1), torch.float32),
        **_distance_specs(uh, ul, fr, dsel, n_dist, rows),
    }
    _check(specs)
    if u_rows < 1 or rows < 1:
        raise ValueError("the step needs a table row and a block")
    form = _form(name, rows, fpb, pad_len)
    if form != LAUNCH_B and group_rows % seg:
        # the split and staged forms serve row r's new side from staged row
        # r+1 of the same segment, blended against row r+1's group: group
        # ends must fall on segment ends
        raise ValueError(f"groups of {group_rows} rows end inside segments of {seg}")
    blocked = int(name != ROW1)
    middle = (table, u_rows, ridx, w, bnd_idx, bnd_w, seg, group_rows, blocked,
              _FORM_CODE[form], xf)
    return _launch(name, form, "fused_step_onehot", _onehot_entry((fpb, pad_len)), device,
                   streams, rows // nb, nb, (uh, ul, fr, dsel, n_dist), middle, rows, pad_len,
                   bins, fpb)


def fused_step_onehot_xfade(
    streams,     # (S, (q-1)*fpb + nb*fpb) history followed by the fed samples
    uh, ul, fr,  # (S*nb, 1) distance phase split; (8, 1) triples with dsel
    table,       # (U_pad, 4*bins) compact filter table [rL | iL | rR | iR];
                 # (G*U_pad, 4*bins) stacked per-group tables with group_tiles
    ridx,        # (S*nb, 4) int32 old-row filter ids, remapped into table (its group)
    w,           # (S*nb, 4) float32 bracket weights
    ridx_last,   # (S, 4) int32 per-source final new rows
    w_last,      # (S, 4)
    xf,          # (S*nb, 1) float32 crossfade mask (> 0: crossfade)
    *, nb: int, pad_len: int, bins: int, fpb: int,
    tb: int | None = None,           # rows per tile (with group_tiles)
    group_tiles: int | None = None,  # tiles per table group (row 2)
    dsel=None,   # (S*nb, 1) int32 triple selector (compact distance)
    n_dist: int | None = None,
) -> torch.Tensor:
    """The batched one-hot step -> (S*nb, 2*fpb).  The new row of a source's
    last block is its ``ridx_last`` row.

    Row 1 (``group_tiles=None``): one shared compact table.  Row 2: every
    ``group_tiles`` consecutive tiles of ``tb`` rows (tiles own whole
    sources, tb % nb == 0) blend against their own slice of ``table``, row
    r reading rows [g*U, (g+1)*U) with g = r // (tb*group_tiles) and U =
    table rows / groups; counted as ``fused_step_onehot_xfade/grouped``."""
    _check_streams(streams, nb, pad_len, fpb)
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    rows = streams.shape[0] * nb
    group_rows, u_rows = _table_groups(rows, nb, table.shape[0], tb, group_tiles)
    operands = [streams, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf]
    device = _where(operands + ([] if dsel is None else [dsel]), pad_len, bins, fpb)
    kw = dict(pad_len=pad_len, bins=bins, fpb=fpb)
    if device.type == "cpu":
        return fused_step_onehot_xfade_reference(*operands, nb=nb, tb=tb, group_tiles=group_tiles,
                                                 dsel=dsel, n_dist=n_dist, **kw)
    if ridx.shape[0] != rows:
        raise ValueError(f"ridx {tuple(ridx.shape)}: want {rows} rows")
    name = "fused_step_onehot_xfade" if group_tiles is None else GROUPED
    return _onehot_cuda(name, device, streams, nb, uh, ul, fr, dsel, n_dist, table, u_rows,
                        ridx, w, ridx_last, w_last, nb, group_rows, xf, **kw)


def fused_step_stream_onehot_xfade(
    stream,      # ((q-1)*fpb + B*fpb,) history followed by the fed samples
    uh, ul, fr,  # (B, 1) distance phase split; (8, 1) triples with dsel
    table,       # (U_pad, 4*bins) compact filter table
    ridx,        # (B, 4) int32 OLD-aligned rows, remapped into table
    w,           # (B, 4)
    ridx_last,   # (1, 4) int32 the final new row, remapped
    w_last,      # (1, 4)
    xf,          # (B, 1) float32 crossfade mask
    *, pad_len: int, bins: int, fpb: int,
    dsel=None,   # (B, 1) int32 triple selector (compact distance)
    n_dist: int | None = None,
) -> torch.Tensor:
    """Row 3, one stream and one compact table -> (B, 2*fpb).  The new row
    of block b is old row b+1; the last block's is ``ridx_last``."""
    b = ridx.shape[0]
    _check_streams(stream, b, pad_len, fpb)
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    operands = [stream, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf]
    device = _where(operands + ([] if dsel is None else [dsel]), pad_len, bins, fpb)
    kw = dict(pad_len=pad_len, bins=bins, fpb=fpb)
    if device.type == "cpu":
        return fused_step_stream_onehot_xfade_reference(*operands, dsel=dsel, n_dist=n_dist, **kw)
    return _onehot_cuda("fused_step_stream_onehot_xfade", device, stream, b, uh, ul, fr, dsel,
                        n_dist, table, table.shape[0], ridx, w, ridx_last, w_last, b, b, xf, **kw)


def fused_step_stream_onehot_grouped_xfade(
    stream,      # ((q-1)*fpb + B*fpb,)
    uh, ul, fr,  # (B, 1); (8, 1) triples with dsel
    tables,      # (G*U_pad, 4*bins) stacked per-group compact tables
    ridx,        # (B, 4) int32 OLD-aligned rows, remapped per group
    w,           # (B, 4)
    rbnd,        # (B/tb, 4) int32 per-tile boundary rows, remapped per group
    wbnd,        # (B/tb, 4)
    xf,          # (B, 1)
    *, pad_len: int, bins: int, fpb: int, tb: int, group_tiles: int, u_pad: int,
    dsel=None, n_dist: int | None = None,
) -> torch.Tensor:
    """Row 4, one stream whose tiles of ``tb`` blocks blend against per-group
    tables -> (B, 2*fpb): tile i reads rows [g*u_pad, (g+1)*u_pad) of
    ``tables`` with g = i // group_tiles.  The new row of block b is old row
    b+1 inside a tile and the tile's ``rbnd`` row at its end."""
    b = ridx.shape[0]
    _check_streams(stream, b, pad_len, fpb)
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    if tb < 1 or group_tiles < 1 or b % tb or (b // tb) % group_tiles:
        raise ValueError(f"{b} blocks do not split into groups of {group_tiles} tiles of {tb}")
    if tables.shape[0] != (b // tb // group_tiles) * u_pad:
        raise ValueError(f"tables {tuple(tables.shape)}: want "
                         f"{b // tb // group_tiles} groups of {u_pad} rows")
    operands = [stream, uh, ul, fr, tables, ridx, w, rbnd, wbnd, xf]
    device = _where(operands + ([] if dsel is None else [dsel]), pad_len, bins, fpb)
    kw = dict(pad_len=pad_len, bins=bins, fpb=fpb)
    if device.type == "cpu":
        return fused_step_stream_onehot_grouped_xfade_reference(
            *operands, tb=tb, group_tiles=group_tiles, u_pad=u_pad, dsel=dsel, n_dist=n_dist, **kw)
    return _onehot_cuda("fused_step_stream_onehot_grouped_xfade", device, stream, b, uh, ul, fr,
                        dsel, n_dist, tables, u_pad, ridx, w, rbnd, wbnd, tb, tb * group_tiles,
                        xf, **kw)


def fused_step_stream_xfade(
    stream,      # ((q-1)*fpb + B*fpb,)
    uh, ul, fr,  # (B, 1); (8, 1) triples with dsel
    g_old,       # (B, 4*bins) old-filter blend rows; the NEW rows when not with_xfade
    g_last,      # (1, 4*bins) the final new-filter row (None when not with_xfade)
    xf,          # (B, 1) float32 crossfade mask (None when not with_xfade)
    *, pad_len: int, bins: int, fpb: int,
    dsel=None, n_dist: int | None = None, with_xfade: bool = True,
) -> torch.Tensor:
    """Row 5, the gather form over one stream -> (B, 2*fpb).  The new row of
    block b is g_old[b+1]; the last block's is ``g_last``.
    ``with_xfade=False``: ``g_old`` carries the NEW rows, g_last and xf are
    ignored, and only the new-side tails are computed (counted apart)."""
    b = g_old.shape[0]
    device = _gather_device(stream, b, uh, ul, fr, g_old, g_last, xf, dsel, n_dist, with_xfade,
                            pad_len=pad_len, bins=bins, fpb=fpb)
    if device.type == "cpu":
        return fused_step_stream_xfade_reference(
            stream, uh, ul, fr, g_old, g_last, xf, dsel=dsel, n_dist=n_dist,
            with_xfade=with_xfade, pad_len=pad_len, bins=bins, fpb=fpb)
    name = "fused_step_stream_xfade" if with_xfade else NO_XFADE
    return _gather_cuda(name, device, stream, 1, b, uh, ul, fr, g_old, g_last, xf, dsel, n_dist,
                        with_xfade, pad_len=pad_len, bins=bins, fpb=fpb)


def fused_step_xfade(
    streams,     # (S, (q-1)*fpb + nb*fpb) history followed by the fed samples
    uh, ul, fr,  # (S*nb, 1) distance phase split; (8, 1) triples with dsel
    g_old,       # (S*nb, 4*bins) old-filter blend rows; the NEW rows when not with_xfade
    g_last,      # (S, 4*bins) per-source final new rows (None when not with_xfade)
    xf,          # (S*nb, 1) float32 crossfade mask (None when not with_xfade)
    *, nb: int, pad_len: int, bins: int, fpb: int,
    dsel=None, n_dist: int | None = None, with_xfade: bool = True,
) -> torch.Tensor:
    """Row 6, the gather form over S sources of nb blocks -> (S*nb, 2*fpb).
    The new row of block b of source s is g_old[s*nb + b + 1] inside the
    source and ``g_last[s]`` at its last block.  ``with_xfade=False``:
    ``g_old`` carries the NEW rows, g_last and xf are ignored, and only the
    new-side tails are computed (counted as ``fused_step_xfade/no_xfade``)."""
    s = streams.shape[0]
    device = _gather_device(streams, nb, uh, ul, fr, g_old, g_last, xf, dsel, n_dist, with_xfade,
                            pad_len=pad_len, bins=bins, fpb=fpb)
    kw = dict(pad_len=pad_len, bins=bins, fpb=fpb)
    if device.type == "cpu":
        return fused_step_xfade_reference(streams, uh, ul, fr, g_old, g_last, xf, nb=nb, dsel=dsel,
                                          n_dist=n_dist, with_xfade=with_xfade, **kw)
    name = "fused_step_xfade" if with_xfade else "fused_step_xfade/no_xfade"
    return _gather_cuda(name, device, streams, s, nb, uh, ul, fr, g_old, g_last, xf, dsel, n_dist,
                        with_xfade, **kw)


def _gather_device(streams, nb, uh, ul, fr, g_old, g_last, xf, dsel, n_dist, with_xfade,
                   *, pad_len, bins, fpb) -> torch.device:
    """Checks shared by rows 5 and 6; the device their operands lie on."""
    _check_streams(streams, nb, pad_len, fpb)
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    if with_xfade and (g_last is None or xf is None):
        raise ValueError("the crossfade form needs g_last and xf")
    operands = [streams, uh, ul, fr, g_old] + ([g_last, xf] if with_xfade else [])
    return _where(operands + ([] if dsel is None else [dsel]), pad_len, bins, fpb)


def _gather_cuda(name, device, streams, n_src, nb, uh, ul, fr, g_old, g_last, xf, dsel, n_dist,
                 with_xfade, *, pad_len, bins, fpb):
    """Rows 5 and 6 on the card: ``n_src`` streams of ``nb`` blocks."""
    rows = n_src * nb
    specs = {
        "streams": (streams, tuple(streams.shape), torch.float32),
        "g_old": (g_old, (rows, 4 * bins), torch.float32),
        **_distance_specs(uh, ul, fr, dsel, n_dist, rows),
    }
    if with_xfade:
        specs["g_last"] = (g_last, (n_src, 4 * bins), torch.float32)
        specs["xf"] = (xf, (rows, 1), torch.float32)
    _check(specs)
    if rows < 1:
        raise ValueError("the step needs a block")
    form = _form(name, rows, fpb, pad_len)
    middle = (g_old, g_last if with_xfade else None, xf if with_xfade else None, int(with_xfade),
              _FORM_CODE[form])
    return _launch(name, form, "fused_step_gather", _gather_entry((fpb, pad_len)), device,
                   streams, n_src, nb, (uh, ul, fr, dsel, n_dist), middle, rows, pad_len, bins,
                   fpb)

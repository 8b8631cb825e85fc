"""Fused GroupNorm + AFNO spectral mixer: the Hopper kernels, their plain
PyTorch version and their gradient.

`fused_gn_afno` replaces the TPU kernel of the same name
(dpot_tpu/ops/pallas/afno_fused.py). For a CUDA tensor it launches one of
eight hand-written kernels through one of ten paths, chosen from the
shapes alone before any launch, or raises:
  - "hopper" (`dpot_tpu_torch/csrc/afno_hopper.cu`): bf16 at the shapes
    `hopper_supported` admits (AFNO blocks of 128 channels, DPOT-Ti, S and
    M at a 16x16 latent); wgmma fed by TMA, two launches;
  - "hopper_wide" (`dpot_tpu_torch/csrc/afno_hopper_wide.cu`): bf16 at the
    shapes `hopper_wide_supported` admits (AFNO blocks of 256 channels,
    DPOT-H at a 16x16 latent); wgmma fed by TMA, the block weights streamed
    through a ring in shared memory, two launches;
  - "hopper_l" (`dpot_tpu_torch/csrc/afno_hopper_l.cu`): bf16 at the shapes
    `hopper_l_supported` admits (AFNO blocks of 96 channels, GroupNorm
    groups of one block or a block pair, DPOT-L at a 16x16 latent); three
    launches: the GroupNorm statistics, a persistent spectral launch whose
    producer warp feeds wgmma through TMA rings, the streamed synthesis;
  - "hopper_f32" (`dpot_tpu_torch/csrc/afno_hopper_f32.cu`): f32 at the
    shapes `hopper_f32_supported` admits (AFNO blocks of 128 channels, any
    latent up to 4096 pixels, any K); every product as 3xTF32 on the
    tensor cores (the split `tf32_split` states), two launches;
  - "hopper_f32_l" (`dpot_tpu_torch/csrc/afno_hopper_f32_l.cu`): f32 at the
    shapes `hopper_f32_l_supported` admits (AFNO blocks of 96 channels, as
    "hopper_l"); "hopper_f32"'s arithmetic, two launches;
  - "hopper_f32_wide" (`dpot_tpu_torch/csrc/afno_hopper_f32_wide.cu`): f32
    at the shapes `hopper_f32_wide_supported` admits (AFNO blocks of 256
    channels, DPOT-H and a tensor-parallel rank's share of it, a latent as
    "hopper_f32"); "hopper_f32"'s arithmetic, two launches;
  - "hopper_pairs" and "hopper_f32_pairs": AFNO blocks of 64 channels
    (configs/afno_config_single.yaml: C 512, 8 blocks) at the shapes
    `hopper_pairs_supported` and `hopper_f32_pairs_supported` admit; each
    pair of blocks (2i, 2i+1) packed into one 128-channel block with
    block-diagonal weights (`pack_pairs`), launched on afno_hopper.cu (bf16)
    or afno_hopper_f32.cu (f32) with nb/2 blocks. The zero products are
    exact and the activation is elementwise, so the result is the
    64-channel mixer's up to the order of the f32 sums;
  - "hopper_stream" (`dpot_tpu_torch/csrc/afno_hopper_stream.cu`): bf16 at
    the shapes `hopper_stream_supported` admits (the latents up to 4096
    pixels, any K, that the other bf16 kernels refuse: every grid but 128^2
    at patch 8; AFNO blocks of 64, 96, 128 or 256 channels); x, A, the
    weights, o and Ainv streamed by TMA through rings in shared memory,
    wgmma, three launches (the GroupNorm statistics, the spectral part, the
    synthesis);
  - "general" (`dpot_tpu_torch/csrc/afno_fused.cu`): every other shape, in
    either type (blocks of other sizes, groups the block rules refuse, an
    odd count of 64-channel blocks in f32 or in bf16 at 128/256 px); five
    launches.
The streamed and f32 kernels work on whole 64-pixel tiles and on a count of
modes that is a multiple of 4: where the latent or K is ragged they read
copies of A and Ainv padded with zeros (`padded_ops`), which is exact, and
leave the pixels past HW out of the statistics and the output.
For a CPU tensor it runs `fused_gn_afno_ref`, which repeats the kernels'
arithmetic with torch ops and rounds at the same points.
`fused_gn_afno.launches` counts the wrapper calls that launched a kernel,
`fused_gn_afno.launches_by_path` the same calls by path; a CUDA graph adds
the launches it holds at every replay (ops/cuda/graphs.py).

The mode MLP's activation is the model's `act`, one of the registry
`dpot_tpu_torch/ops/activations.py`; `approximate` picks tanh-GELU over
erf-GELU when act is "gelu" (the model passes it for bf16, as the registry
does).

When gradients are wanted the call goes through a `torch.autograd.Function`
whose backward is `fused_gn_afno_vjp`: an explicit vector-Jacobian product
in torch ops that recomputes the forward's intermediates, as the JAX
package's `_bwd` recomputes through `_xla_reference` (the TPU kernel has no
backward kernel either). The backward never runs the plain forward, so on
the card the plain version stays off the training path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.cuda.graphs import capturing
from dpot_tpu_torch.ops.norms import group_norm
from dpot_tpu_torch.ops.spectral import COMBINED_MAX_PIXELS, complex_as_real_weight

# activation ids of dpot_tpu_torch/csrc/activation.cuh; "gelu" is 0 (tanh
# form) or 1 (erf form) by `approximate`
ACT_IDS = {"gelu": 0, "tanh": 2, "sigmoid": 3, "relu": 4, "leaky_relu": 5,
           "softplus": 6, "ELU": 7, "elu": 7, "silu": 8}


def act_id(act: str, approximate: bool) -> int:
    """The kernels' id of activation `act`."""
    if act not in ACT_IDS:
        raise ValueError(f"unknown activation {act!r}; available: {sorted(ACT_IDS)}")
    return ACT_IDS[act] + int(act == "gelu" and not approximate)


def _act(act: str, approximate: bool):
    """The activation in f32, as the kernels apply it."""
    if act == "gelu":
        return functools.partial(F.gelu, approximate="tanh" if approximate else "none")
    return get_activation(act)


def _act_grad(act: str, approximate: bool, h: torch.Tensor) -> torch.Tensor:
    """d act(h) / dh, elementwise, as torch.autograd differentiates `_act`."""
    if act == "gelu":
        if approximate:
            c = math.sqrt(2.0 / math.pi)
            t = torch.tanh(c * (h + 0.044715 * h * h * h))
            return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * h * h)
        cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
        return cdf + h * torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))
    if act == "tanh":
        return 1.0 - torch.tanh(h).square()
    if act == "sigmoid":
        s = torch.sigmoid(h)
        return s * (1.0 - s)
    if act == "relu":
        return (h > 0).to(h.dtype)
    if act == "leaky_relu":
        return torch.where(h > 0, 1.0, 0.1).to(h.dtype)
    if act == "softplus":
        return torch.where(h > 20.0, 1.0, torch.sigmoid(h))
    if act in ("elu", "ELU"):
        return torch.where(h > 0, 1.0, torch.exp(h))
    if act == "silu":
        s = torch.sigmoid(h)
        return s * (1.0 + h * (1.0 - s))
    raise ValueError(f"unknown activation {act!r}; available: {sorted(ACT_IDS)}")


def fused_gn_afno_ref(
    x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K: int, groups: int = 8,
    approximate: bool = True, act: str = "gelu",
) -> torch.Tensor:
    """Plain version of the kernels. Every product takes operands rounded to
    x's dtype and accumulates in f32; xn, z, the hidden layer and o are
    rounded where the kernels round them; the residual adds the f32 xn."""
    cd = x.dtype
    B, HW, C = x.shape
    nb = w1.shape[1]
    bs = C // nb

    def rnd(t):
        return t.to(cd).float()

    xn32 = group_norm(x.float(), gscale, gbias, groups)
    z = rnd(torch.matmul(A.float(), rnd(xn32)))                   # (B, 2K, C)
    zj = torch.cat(
        [z[:, :K].reshape(B, K, nb, bs), z[:, K:].reshape(B, K, nb, bs)], dim=-1
    )                                                              # (B, K, nb, 2bs)
    W1 = rnd(complex_as_real_weight(w1[0], w1[1]))
    W2 = rnd(complex_as_real_weight(w2[0], w2[1]))
    B1 = torch.cat([b1[0], b1[1]], dim=-1)
    B2 = torch.cat([b2[0], b2[1]], dim=-1)
    h = torch.einsum("bkji,jio->bkjo", zj, W1) + B1
    h = rnd(_act(act, approximate)(h))
    o = torch.einsum("bkji,jio->bkjo", h, W2) + B2
    ob = rnd(
        torch.cat([o[..., :bs].reshape(B, K, C), o[..., bs:].reshape(B, K, C)], dim=1)
    )
    y = torch.matmul(Ainv.float(), ob)
    return (y + xn32).to(x.dtype)


# signatures of argument lists that passed _check, so that a repeated call
# pays for one tuple and one set lookup
_CHECKED: set = set()


def _check(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups, act):
    args = (x, gscale, gbias, A, Ainv, w1, b1, w2, b2)
    sig = (K, groups, act,
           *[(t.shape, t.dtype, t.get_device(), t.is_contiguous()) for t in args])
    if sig in _CHECKED:
        return
    if x.dim() != 3:
        raise ValueError(f"x must be (B, HW, C), got {tuple(x.shape)}")
    B, HW, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if w1.dim() != 4 or w1.shape[0] != 2:
        raise ValueError(f"w1 must be (2, nb, bs, bs), got {tuple(w1.shape)}")
    nb = w1.shape[1]
    if C % nb:
        raise ValueError(f"C={C} is not divisible by nb={nb}")
    bs = C // nb
    if tuple(w1.shape) != (2, nb, bs, bs) or tuple(w2.shape) != (2, nb, bs, bs):
        raise ValueError(
            f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} must be {(2, nb, bs, bs)}: "
            "the fused kernel needs hidden_size_factor == 1"
        )
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} is not divisible by groups={groups}")
    if HW > COMBINED_MAX_PIXELS:
        raise ValueError(
            f"latent of {HW} px exceeds {COMBINED_MAX_PIXELS}: such latents take the "
            "separable route (ops/spectral.py separable_gn_afno), not the fused op")
    act_id(act, True)
    f32 = (torch.float32,)
    weight = (torch.float32, torch.bfloat16)
    shapes = {
        "gscale": (gscale, (C,), f32),
        "gbias": (gbias, (C,), f32),
        "A": (A, (2 * K, HW), (x.dtype,)),
        "Ainv": (Ainv, (HW, 2 * K), (x.dtype,)),
        "w1": (w1, (2, nb, bs, bs), weight),
        "b1": (b1, (2, nb, bs), f32),
        "w2": (w2, (2, nb, bs, bs), weight),
        "b2": (b2, (2, nb, bs), f32),
    }
    for name, (t, shape, dtypes) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if len(_CHECKED) > 256:
        _CHECKED.clear()
    _CHECKED.add(sig)


# ---------------------------------------------------------------- the Hopper path
HOPPER_BS = 128       # the AFNO block size of afno_hopper.cu and afno_hopper_f32.cu
HOPPER_WIDE_BS = 256  # the AFNO block size of afno_hopper_wide.cu and afno_hopper_f32_wide.cu
HOPPER_L_BS = 96      # the AFNO block size of afno_hopper_l.cu and afno_hopper_f32_l.cu
HOPPER_MAX_NK = 5     # 64-row blocks of o (2K rows) a synthesis CTA holds: MAX_NK
HOPPER_TILE_C = 128   # channels per bf16 synthesis CTA (hopper_tma.cuh): TILE_C
HOPPER_F32_TILE_P = 64  # pixels per synthesis CTA of afno_hopper_f32.cu: MAX_TP
HOPPER_F32_TILE_C = 64  # channels per f32 synthesis CTA: TC
PADDED_K_UNIT = 4     # Kp's unit for the streamed and f32 kernels: KP_UNIT, padded_k


def _hopper_blocks(B: int, C: int, nb: int, groups: int, bs: int = HOPPER_BS) -> bool:
    """The layout the Hopper kernels for blocks of 128 and 256 channels are
    written for: AFNO blocks of bs channels, a batch that fits a grid's z
    dimension, and GroupNorm groups of a power of two channels between 8
    and bs, so that a group lies inside one AFNO block."""
    if nb < 1 or C != nb * bs or not 1 <= B <= 65535 or groups < 1 or C % groups:
        return False
    cpg = C // groups
    return 8 <= cpg <= bs and not cpg & (cpg - 1)


def _l_blocks(B: int, C: int, nb: int, groups: int, tile_c: int) -> bool:
    """The layout the kernels for blocks of 96 channels are written for:
    AFNO blocks of 96 channels, C a multiple of their synthesis launch's
    channel tile `tile_c`, a batch that fits a grid's z dimension, and
    GroupNorm groups of one block or of a block pair (96 or 192 channels;
    DPOT-L's GroupNorm(8) over 1536 channels), so that each block lies
    inside one group and a CTA reads its whole group for the statistics."""
    if (nb < 1 or C != nb * HOPPER_L_BS or C % tile_c or not 1 <= B <= 65535
            or groups < 1 or C % groups):
        return False
    return C // groups in (HOPPER_L_BS, 2 * HOPPER_L_BS)


def _bf16_hopper_latent(HW: int, K: int) -> bool:
    """The latent and modes every bf16 Hopper kernel takes: 128 or 256
    pixels (the x slab and the A rows fit in shared memory); K a multiple
    of 4 (Ainv's rows are whole 16-byte units) with 2K <= 320, so that all
    of o for one CTA of their shared synthesis launch fits in shared
    memory."""
    return HW in (128, 256) and K >= 1 and not K % 4 and -(-2 * K // 64) <= HOPPER_MAX_NK


def _f32_hopper_latent(HW: int, K: int) -> bool:
    """The latent and modes the f32 Hopper kernels take: any latent up to
    COMBINED_MAX_PIXELS and any K. They work on whole 64-pixel tiles and an
    even count of modes (Ainv's rows whole 16-byte units), on copies of A
    and Ainv padded to that (`padded_ops`), and mask the pixels past HW."""
    return 1 <= HW <= COMBINED_MAX_PIXELS and K >= 1


def _stream_latent(HW: int, K: int) -> bool:
    """The latent and modes afno_hopper_stream.cu takes: the f32 kernels'
    (`_f32_hopper_latent`: x, A, o and Ainv all stream in chunks, the
    operators padded) but none that `_bf16_hopper_latent` admits, which the
    other bf16 kernels keep."""
    return _f32_hopper_latent(HW, K) and not _bf16_hopper_latent(HW, K)


def padded_dims(HW: int, K: int) -> tuple[int, int]:
    """(HWp, Kp): the latent rounded up to whole 64-pixel tiles
    (HOPPER_F32_TILE_P) and K rounded up to a multiple of PADDED_K_UNIT, the
    shapes the streamed and f32 kernels read A (2Kp, HWp) and Ainv (HWp,
    2Kp) at: the streamed kernel reads Ainv through a tensor map, whose
    row stride (4 Kp bytes in bf16) must be a multiple of 16 bytes; the f32
    kernels take any even Kp, so one padded copy serves both types. The
    kernels compute the same from HW and K."""
    return (-(-HW // HOPPER_F32_TILE_P) * HOPPER_F32_TILE_P,
            -(-K // PADDED_K_UNIT) * PADDED_K_UNIT)


def padded_ops(A: torch.Tensor, Ainv: torch.Tensor, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A (2K, HW) and Ainv (HW, 2K) at `padded_dims`: zero columns of A past
    HW and zero rows of Ainv past HW; where K is not a multiple of 4 zero
    modes K .. Kp - 1 in both halves (rows K .. Kp - 1 and Kp + K .. 2Kp - 1
    of A, the same columns of Ainv). Exact: a padded pixel meets a zero
    column of A, and a padded mode's o (act(B1) . W2 + B2) a zero column of
    Ainv. A and Ainv themselves where nothing is padded.
    The copies are constants, as the operators are (ops/spectral.py
    `combined_spectral_ops`): kept on A for as long as A lives, never
    evicted (a CUDA graph reads them by address), made outside inference
    mode. A miss while a graph is being captured raises: the capture's
    warm-up must have made them."""
    HW = A.shape[1]
    HWp, Kp = padded_dims(HW, K)
    if (HWp, Kp) == (HW, K):
        return A, Ainv
    versions = tuple(-1 if t.is_inference() else t._version for t in (A, Ainv))
    cached = getattr(A, "_dpot_padded", None)
    if cached is not None and cached[0] is Ainv and cached[1] == versions:
        return cached[2]
    if capturing():
        raise RuntimeError(
            f"the padded DFT operators of a {HW}-px latent with K {K} are not cached: a "
            "CUDA graph cannot make them during its capture; run the function once "
            "eagerly first")
    with torch.inference_mode(False):
        Ap = A.new_zeros((2 * Kp, HWp))
        Ap[:K, :HW] = A[:K]
        Ap[Kp:Kp + K, :HW] = A[K:]
        Ainvp = Ainv.new_zeros((HWp, 2 * Kp))
        Ainvp[:HW, :K] = Ainv[:, :K]
        Ainvp[:HW, Kp:Kp + K] = Ainv[:, K:]
    A._dpot_padded = (Ainv, versions, (Ap, Ainvp))
    return Ap, Ainvp


def hopper_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                     dtype: torch.dtype) -> bool:
    """Whether afno_hopper.cu takes these shapes: bf16, `_bf16_hopper_latent`,
    AFNO blocks of 128 channels with groups of 8 to 128 (`_hopper_blocks`).
    A pure function of the shapes, mirrored by dpot_afno_hopper_supported in
    the source."""
    return (dtype == torch.bfloat16 and _bf16_hopper_latent(HW, K)
            and _hopper_blocks(B, C, nb, groups, HOPPER_BS))


def hopper_wide_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                          dtype: torch.dtype) -> bool:
    """Whether afno_hopper_wide.cu takes these shapes: bf16,
    `_bf16_hopper_latent`, AFNO blocks of 256 channels with groups of 8 to
    256. A pure function of the shapes, mirrored by
    dpot_afno_hopper_wide_supported in the source."""
    return (dtype == torch.bfloat16 and _bf16_hopper_latent(HW, K)
            and _hopper_blocks(B, C, nb, groups, HOPPER_WIDE_BS))


def hopper_l_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                       dtype: torch.dtype) -> bool:
    """Whether afno_hopper_l.cu takes these shapes: bf16,
    `_bf16_hopper_latent`, AFNO blocks of 96 channels with groups of one
    block or a block pair and C a multiple of 128 (`_l_blocks`). A pure
    function of the shapes, mirrored by dpot_afno_hopper_l_supported in the
    source."""
    return (dtype == torch.bfloat16 and _bf16_hopper_latent(HW, K)
            and _l_blocks(B, C, nb, groups, HOPPER_TILE_C))


def hopper_f32_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                         dtype: torch.dtype) -> bool:
    """Whether afno_hopper_f32.cu takes these shapes: f32,
    `_f32_hopper_latent`, AFNO blocks of 128 channels with groups of 8 to
    128 (`_hopper_blocks`). A pure function of the shapes, mirrored by
    dpot_afno_hopper_f32_supported in the source."""
    return (dtype == torch.float32 and _f32_hopper_latent(HW, K)
            and _hopper_blocks(B, C, nb, groups))


def hopper_f32_l_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                           dtype: torch.dtype) -> bool:
    """Whether afno_hopper_f32_l.cu takes these shapes: f32,
    `_f32_hopper_latent`, AFNO blocks of 96 channels with groups of one
    block or a block pair and C a multiple of 64 (`_l_blocks`). A pure
    function of the shapes, mirrored by dpot_afno_hopper_f32_l_supported in
    the source."""
    return (dtype == torch.float32 and _f32_hopper_latent(HW, K)
            and _l_blocks(B, C, nb, groups, HOPPER_F32_TILE_C))


def hopper_f32_wide_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                              dtype: torch.dtype) -> bool:
    """Whether afno_hopper_f32_wide.cu takes these shapes: f32,
    `_f32_hopper_latent`, AFNO blocks of 256 channels with groups of 8 to
    256 (`_hopper_blocks`). A pure function of the shapes, mirrored by
    dpot_afno_hopper_f32_wide_supported in the source."""
    return (dtype == torch.float32 and _f32_hopper_latent(HW, K)
            and _hopper_blocks(B, C, nb, groups, HOPPER_WIDE_BS))


PAIR_BS = 64  # the AFNO block size that the pair paths pack two at a time


def _pair_blocks(B: int, C: int, nb: int, groups: int) -> bool:
    """AFNO blocks of 64 channels, an even count of them, and GroupNorm
    groups of a power of two channels between 8 and 64, so that every group
    lies inside one 64-channel block; the packed pairs are then the layout
    of the kernels for blocks of 128 channels (`_hopper_blocks` at nb/2)."""
    return (nb >= 2 and not nb % 2 and C == nb * PAIR_BS and groups >= 1
            and not C % groups and C // groups <= PAIR_BS
            and _hopper_blocks(B, C, nb // 2, groups))


def hopper_pairs_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                           dtype: torch.dtype) -> bool:
    """Whether the pair path runs afno_hopper.cu at these shapes: bf16,
    `_bf16_hopper_latent`, an even count of 64-channel AFNO blocks with
    groups of 8 to 64 (`_pair_blocks`). dpot_afno_hopper_supported at
    (nb/2, blocks of 128) admits every such shape."""
    return (dtype == torch.bfloat16 and _bf16_hopper_latent(HW, K)
            and _pair_blocks(B, C, nb, groups))


def hopper_f32_pairs_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                               dtype: torch.dtype) -> bool:
    """Whether the pair path runs afno_hopper_f32.cu at these shapes: f32,
    `_f32_hopper_latent`, an even count of 64-channel AFNO blocks with
    groups of 8 to 64 (`_pair_blocks`). dpot_afno_hopper_f32_supported at
    (nb/2, blocks of 128) admits every such shape."""
    return (dtype == torch.float32 and _f32_hopper_latent(HW, K)
            and _pair_blocks(B, C, nb, groups))


def _stream_blocks(B: int, C: int, nb: int, groups: int) -> bool:
    """The layouts afno_hopper_stream.cu is written for: AFNO blocks of 96
    channels as `_l_blocks` states them (groups of one block or a block
    pair), or of 64, 128 or 256 channels, any count, with groups of a power
    of two channels inside a block (`_hopper_blocks`); C a multiple of its
    synthesis tile of 64 channels."""
    if nb < 1 or C % nb:
        return False
    bs = C // nb
    if bs == HOPPER_L_BS:
        return _l_blocks(B, C, nb, groups, HOPPER_F32_TILE_C)
    return bs in (PAIR_BS, HOPPER_BS, HOPPER_WIDE_BS) and _hopper_blocks(B, C, nb, groups, bs)


def hopper_stream_supported(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                            dtype: torch.dtype) -> bool:
    """Whether afno_hopper_stream.cu takes these shapes: bf16,
    `_stream_latent`, `_stream_blocks`. A pure function of the shapes,
    mirrored by dpot_afno_hopper_stream_supported in the source."""
    return (dtype == torch.bfloat16 and _stream_latent(HW, K)
            and _stream_blocks(B, C, nb, groups))


# every kernel a call may launch, in the order kernel_path asks the gates
PATHS = ("hopper", "hopper_wide", "hopper_l", "hopper_f32", "hopper_f32_l",
         "hopper_f32_wide", "hopper_pairs", "hopper_f32_pairs", "hopper_stream", "general")
_GATES = (hopper_supported, hopper_wide_supported, hopper_l_supported,
          hopper_f32_supported, hopper_f32_l_supported, hopper_f32_wide_supported,
          hopper_pairs_supported, hopper_f32_pairs_supported, hopper_stream_supported)
# the pair paths and the kernel each launches at nb/2 blocks of 128 channels
PAIR_KERNELS = {"hopper_pairs": "hopper", "hopper_f32_pairs": "hopper_f32"}
# the paths whose kernels read the bf16 copies of the block weights
BF16_WEIGHT_PATHS = ("hopper", "hopper_wide", "hopper_l", "hopper_pairs", "hopper_stream")


def kernel_path(B: int, HW: int, C: int, K: int, nb: int, groups: int,
                dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes launches: the path of the
    first gate that admits them (the gates admit disjoint shapes), else
    "general"."""
    for path, gate in zip(PATHS, _GATES):
        if gate(B, HW, C, K, nb, groups, dtype):
            return path
    return "general"


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a (f32) as hi + lo, both TF32 values (10 explicit mantissa bits, the
    low 13 bits zero), each rounded to nearest with ties away from zero
    (cvt.rna's rounding): what afno_hopper_f32.cu does, by the same integer
    ops on the bits, to every operand it loads.
    hi + lo equals a to about 2^-22 relative, so the three products
    lo.hi' + hi.lo' + hi.hi' (3xTF32) are as close to an f32 product as
    f32 is to f64, where hi.hi' alone (single-pass TF32) keeps about three
    decimal digits."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    a = a.float()
    hi = rna(a)
    return hi, rna(a - hi)


# the profiler range around the making of the bf16 weight copies, so that a
# trace can count their device time with the Hopper kernel's
BF16_BLOCKS_RANGE = "fused_gn_afno.bf16_blocks"


def pack_pairs(w: torch.Tensor) -> torch.Tensor:
    """w (2, nb, bs, bs) -> (2, nb/2, 2bs, 2bs): blocks 2i and 2i+1 on the
    diagonal of block i, zeros off it, for the real and the imaginary part
    alike. The complex block MLP with such weights is block-diagonal, so
    block i of the packed mixer is blocks 2i and 2i+1 of w side by side."""
    two, nb, bs, _ = w.shape
    out = w.new_zeros((two, nb // 2, 2 * bs, 2 * bs))
    out[:, :, :bs, :bs] = w[:, 0::2]
    out[:, :, bs:, bs:] = w[:, 1::2]
    return out


def _cached(w: torch.Tensor, attr: str, convert) -> torch.Tensor:
    """convert(w), cached on w under `attr` until w changes (its version
    counter or storage), so serving converts once and training once per
    optimizer step. A CUDA graph being captured always converts, and keeps
    nothing: a cached copy would be frozen into the graph, which must read
    w as it is at each replay (ops/cuda/graphs.py). Nor does a weight marked
    `_dpot_block_cache = False`: a parameter of a model sharded by FSDP2,
    which gathers new values into the same tensor, at the same address and
    under the same version, at every step (parallel/fsdp.py `no_block_cache`)."""
    if (w.is_inference() or capturing()
            or not getattr(w, "_dpot_block_cache", True)):  # convert every call
        return convert(w)
    key = (w.data_ptr(), w._version)
    cached = getattr(w, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, convert(w.detach()))
        setattr(w, attr, cached)
    return cached[1]


def _bf16_blocks(w: torch.Tensor, pairs: bool = False) -> torch.Tensor:
    """w (2, nb, bs, bs), f32 or a bf16 working copy, as bf16 with each block
    transposed to (out, in), the layout the bf16 Hopper kernels load with
    TMA; with `pairs`, packed first (`pack_pairs`). Cached by `_cached`."""
    if pairs:
        return _cached(w, "_dpot_bf16_pairs", functools.partial(_convert_blocks, pairs=True))
    return _cached(w, "_dpot_bf16_blocks", _convert_blocks)


def _convert_blocks(w: torch.Tensor, pairs: bool = False) -> torch.Tensor:
    with torch.profiler.record_function(BF16_BLOCKS_RANGE):
        if pairs:
            w = pack_pairs(w)
        return w.transpose(-1, -2).to(torch.bfloat16).contiguous()


def _f32_pairs(w: torch.Tensor) -> torch.Tensor:
    """w (2, nb, 64, 64), f32 or a bf16 working copy (upcast, exact), packed
    (`pack_pairs`) in f32 in the reference layout that afno_hopper_f32.cu
    reads. Cached by `_cached`."""
    return _cached(w, "_dpot_f32_pairs", lambda t: pack_pairs(t.float()))


@functools.cache
def _kernel_fn(path: str):
    from dpot_tpu_torch.ops.cuda.build import load_library

    p, i = ctypes.c_void_p, ctypes.c_int
    path = PAIR_KERNELS.get(path, path)
    if path != "general":
        fn = getattr(load_library("afno_" + path), "dpot_afno_" + path)
        fn.argtypes = [i] + [p] * 12 + [i] * 6 + [p]
    else:
        fn = load_library("afno_fused").dpot_fused_gn_afno
        fn.argtypes = [i, i] + [p] * 14 + [i] * 6 + [p]
    fn.restype = i
    return fn


def _forward(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups, approximate, act):
    """A kernel on a CUDA tensor, the plain version on a CPU tensor."""
    args = (x, gscale, gbias, A, Ainv, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_gn_afno_ref(*args, K, groups, approximate, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_afno runs on cuda or cpu, not {x.device}")
    B, HW, C = x.shape
    nb = w1.shape[1]
    aid = act_id(act, approximate)
    dev = x.device
    path = kernel_path(B, HW, C, K, nb, groups, x.dtype)
    if path != "general":  # the Hopper kernels' operators, padded where ragged
        A, Ainv = padded_ops(A, Ainv, K)
        args = (*args[:3], A, Ainv, *args[5:])
    Kp = A.shape[0] // 2
    # The scratch is freed on return, before the kernels have run; the caching
    # allocator hands it out again only to later work on this same stream.
    stats = torch.empty(B * groups * 2, device=dev, dtype=torch.float32)
    o = torch.empty((B, 2 * Kp, C), device=dev, dtype=x.dtype)
    out = torch.empty_like(x)
    pairs = path in PAIR_KERNELS
    if pairs:
        # b1 and b2 (2, nb, 64) are the same memory as (2, nb/2, 128)
        nb //= 2
    if path in BF16_WEIGHT_PATHS:
        ptrs = (x, gscale, gbias, A, Ainv, _bf16_blocks(w1, pairs), b1,
                _bf16_blocks(w2, pairs), b2, stats, o, out)
        flags = (aid,)
    else:
        # these kernels read f32 weights: a bf16 working copy is upcast (exact)
        if pairs:
            args = (*args[:5], _f32_pairs(w1), b1, _f32_pairs(w2), b2)
        else:
            args = (*args[:5], w1.float(), b1, w2.float(), b2)
        if path == "general":
            z = torch.empty_like(o)
            h = torch.empty((B * K, nb, 2 * (C // nb)), device=dev, dtype=x.dtype)
            ptrs = (*args, stats, z, h, o, out)
            flags = (int(x.dtype == torch.bfloat16), aid)
        else:  # the f32 Hopper kernels
            ptrs = (*args, stats, o, out)
            flags = (aid,)
    with torch.cuda.device(dev):
        err = _kernel_fn(path)(
            *flags, *[t.data_ptr() for t in ptrs], B, HW, C, K, nb, groups,
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if err != 0:
        what = (f"tensor-map encoding failed: CUresult {err - 10000}" if err >= 10000
                else f"CUDA error {err}")
        raise RuntimeError(f"fused_gn_afno {path} kernel launch failed: {what}")
    fused_gn_afno.launches += 1
    fused_gn_afno.launches_by_path[path] += 1
    return out


def _real_form_grad(gW: torch.Tensor) -> torch.Tensor:
    """Cotangent of the real form [[wr, wi], [-wi, wr]] (nb, 2bs, 2bs) ->
    cotangent of the reference layout (2, nb, bs, bs)."""
    bs = gW.shape[-1] // 2
    gwr = gW[:, :bs, :bs] + gW[:, bs:, bs:]
    gwi = gW[:, :bs, bs:] - gW[:, bs:, :bs]
    return torch.stack([gwr, gwi])


def fused_gn_afno_vjp(
    g, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K: int, groups: int = 8,
    approximate: bool = True, act: str = "gelu", eps: float = 1e-5,
):
    """Vector-Jacobian product of `fused_gn_afno` for the output cotangent g
    (B, HW, C). Returns the cotangents of (x, gscale, gbias, w1, b1, w2, b2),
    x's of x's dtype and the rest f32 in the reference layout; A and Ainv are
    constants. It recomputes the f32 GroupNorm, xn, z and the hidden layer,
    rounded to x's dtype where the forward rounds them, then walks back
    through Ainv, the second layer, act', the first layer and A, adds the
    residual's cotangent to xn's and goes back through the GroupNorm. The
    cotangents are rounded at the forward's rounding points, as
    differentiating the forward (JAX's `_bwd`) rounds them; every product is
    f32."""
    cd = x.dtype
    B, HW, C = x.shape
    nb = w1.shape[1]
    bs = C // nb
    Cg = C // groups

    def rnd(t):
        return t.to(cd).float()

    # forward recompute
    xg = x.float().reshape(B, HW, groups, Cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt((xg - mean).square().mean(dim=(1, 3), keepdim=True) + eps)
    xhat = ((xg - mean) * rstd).reshape(B, HW, C)
    xnb = rnd(xhat * gscale + gbias)
    A32, Ainv32 = A.float(), Ainv.float()
    z = rnd(torch.matmul(A32, xnb))                                  # (B, 2K, C)
    zj = torch.cat(
        [z[:, :K].reshape(B, K, nb, bs), z[:, K:].reshape(B, K, nb, bs)], dim=-1
    )
    W1 = rnd(complex_as_real_weight(w1[0], w1[1]))
    W2 = rnd(complex_as_real_weight(w2[0], w2[1]))
    hpre = torch.einsum("bkji,jio->bkjo", zj, W1) + torch.cat([b1[0], b1[1]], dim=-1)
    h = rnd(_act(act, approximate)(hpre))

    # backward
    g32 = g.float()
    gob = rnd(torch.matmul(Ainv32.t(), g32))                         # (B, 2K, C)
    go = torch.cat(
        [gob[:, :K].reshape(B, K, nb, bs), gob[:, K:].reshape(B, K, nb, bs)], dim=-1
    )
    gB2 = go.sum(dim=(0, 1))
    gW2 = rnd(torch.einsum("bkji,bkjo->jio", h, go))
    gh = rnd(torch.einsum("bkjo,jio->bkji", go, W2))
    ghpre = gh * _act_grad(act, approximate, hpre)
    gB1 = ghpre.sum(dim=(0, 1))
    gW1 = rnd(torch.einsum("bkji,bkjo->jio", zj, ghpre))
    gzj = rnd(torch.einsum("bkjo,jio->bkji", ghpre, W1))
    gz = torch.cat([gzj[..., :bs].reshape(B, K, C), gzj[..., bs:].reshape(B, K, C)], dim=1)
    gxn = rnd(torch.matmul(A32.t(), gz)) + g32                       # + residual
    ggscale = (gxn * xhat).sum(dim=(0, 1))
    ggbias = gxn.sum(dim=(0, 1))
    gxh = (gxn * gscale).reshape(B, HW, groups, Cg)
    xh = xhat.reshape(B, HW, groups, Cg)
    gx = rstd * (
        gxh - gxh.mean(dim=(1, 3), keepdim=True)
        - xh * (gxh * xh).mean(dim=(1, 3), keepdim=True)
    )
    return (
        gx.reshape(B, HW, C).to(cd), ggscale, ggbias,
        _real_form_grad(gW1), torch.stack([gB1[..., :bs], gB1[..., bs:]]),
        _real_form_grad(gW2), torch.stack([gB2[..., :bs], gB2[..., bs:]]),
    )


class FusedGnAfno(torch.autograd.Function):
    """fused_gn_afno with its VJP: the forward launches the kernel (CUDA) or
    runs the plain version (CPU); the backward is `fused_gn_afno_vjp` on
    either device. A and Ainv get no gradient."""

    @staticmethod
    def forward(ctx, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups, approximate, act):
        ctx.save_for_backward(x, gscale, gbias, A, Ainv, w1, b1, w2, b2)
        ctx.cfg = (K, groups, approximate, act)
        return _forward(x, gscale, gbias, A, Ainv, w1, b1, w2, b2, K, groups, approximate, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx, ggs, ggb, gw1, gb1, gw2, gb2 = fused_gn_afno_vjp(
            g.contiguous(), *ctx.saved_tensors, *ctx.cfg
        )
        return gx, ggs, ggb, None, None, gw1, gb1, gw2, gb2, None, None, None, None


def fused_gn_afno(
    x: torch.Tensor,
    gscale: torch.Tensor,
    gbias: torch.Tensor,
    A: torch.Tensor,
    Ainv: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    K: int,
    groups: int = 8,
    approximate: bool = True,
    act: str = "gelu",
) -> torch.Tensor:
    """GroupNorm(groups) + AFNO mixer with its internal residual.

    x: (B, HW, C) bf16 or f32, the operand type; A (2K, HW) and Ainv
    (HW, 2K) of that type; gscale/gbias (C,), w1/w2 (2, nb, bs, bs) and
    b1/b2 (2, nb, bs) in the reference layout, f32 or a bf16 working copy
    (train/state.py). The kernels read the vectors as f32, so bf16 ones are
    upcast here, which is exact; bf16 weights go to the bf16 kernels as
    they are and are upcast for the others. act is the mode MLP's
    activation (a name of the registry); for "gelu", approximate selects
    the tanh form (the TPU kernel, bf16) or the erf form (the JAX f32
    path). Returns (B, HW, C) of x's dtype, with a `FusedGnAfno` grad_fn
    when grad mode is on and an input requires grad; the cotangents of bf16
    arguments reach them rounded to bf16 (autograd casts them)."""
    gscale, gbias, b1, b2 = (t.float() for t in (gscale, gbias, b1, b2))
    args = (x, gscale, gbias, A, Ainv, w1, b1, w2, b2)
    _check(*args, K, groups, act)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedGnAfno.apply(*args, K, groups, approximate, act)
    return _forward(*args, K, groups, approximate, act)


fused_gn_afno.launches = 0
fused_gn_afno.launches_by_path = dict.fromkeys(PATHS, 0)

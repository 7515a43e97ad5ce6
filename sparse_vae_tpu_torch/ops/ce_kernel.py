"""K3 and K3b: the tied vocab projection fused with softmax cross-entropy,
forward and backward, as CUDA kernels (csrc/tied_ce.cu, csrc/tied_ce_bwd.cu),
replacing sparse_vae_tpu/ops/pallas_ce.py::_fwd and ::_bwd.

Logits = g @ table^T + bias over the tied input embedding table; the
[T, V] logits never reach device memory on the kernel path (K3b keeps one
chunk of bf16 logit gradients, at most DL_SCRATCH_BYTES, in scratch:
`tied_ce_bwd_chunked`). `tied_ce_fwd` and `tied_ce_bwd` launch the kernels
for CUDA tensors and run the plain versions (`tied_ce_fwd_plain`,
`tied_ce_bwd_plain`, over token chunks) for CPU tensors.
`FusedTiedCrossEntropy` is the autograd Function around the pair, the
counterpart of the JAX package's `fused_tied_cross_entropy`.

As there, the label logit g . E[label] + bias[label] and the backward's
-dnll * E[label] term are row gathers outside the kernels, in fp32: the
two terms of dg nearly cancel for well-predicted tokens, so they meet in
fp32 and round once.
"""
from __future__ import annotations

import torch

from . import cuda_lib

# Kernel launches in this process (raised only where a kernel launches):
# K3 in `fwd_launches`, K3b (the chunked kernels of one backward) in
# `bwd_launches`, at D = 512; at D = 256 in `fwd_launches_d256` and
# `bwd_launches_d256` instead. `plain_routes` counts CPU losses inside the JAX
# package's fused-CE gate at a width the kernels do not take (`route` ==
# "plain"); `take_plain_route` raises it.
fwd_launches = 0
bwd_launches = 0
fwd_launches_d256 = 0
bwd_launches_d256 = 0
plain_routes = 0

# The model widths the kernels are instantiated at: the Transformer-VAE's
# and the Transformer LM's (csrc/tied_ce.cu, csrc/tied_ce_bwd.cu).
D_MODELS = (256, 512)
# K3's vocab tiles: 128 rows of the table each.
VOCAB_TILE = 128
# K3b: its output tiles are 128 tokens by 128 vocab rows, and its bf16
# logit-gradient scratch [C, V] holds at most this many bytes.
BWD_TILE = 128
DL_SCRATCH_BYTES = 10**9


def route(tied: bool, vocab_size: int, d_model: int) -> str:
    """How a sequence loss with the kernels on is computed, as the JAX
    package dispatches it (models/transformer_lm.py `sequence_nll`: the
    fused kernel for a tied output table with V % 1024 == 0):

    - "kernel": inside that gate at a K3/K3b instantiation (D in
      D_MODELS; V % 1024 == 0 covers the kernels' V % 128);
    - "plain": inside the gate at another width: the plain version on the
      CPU, counted in `plain_routes`; on the card it raises
      (`take_plain_route`);
    - "outside": outside the gate: the plain chunked CE, as JAX takes its
      chunked XLA path there.
    """
    if not (tied and vocab_size % 1024 == 0):
        return "outside"
    return "kernel" if d_model in D_MODELS else "plain"


def take_plain_route(device: torch.device, d_model: int):
    """Account for a loss that `route` gives "plain": on the CPU count it
    in `plain_routes` (the caller then runs the plain version); on any
    other device raise, as the JAX package runs its fused kernel at this
    width and the port has no CUDA instantiation of it."""
    global plain_routes
    if device.type != "cpu":
        raise NotImplementedError(
            f"no CUDA instantiation of the fused tied CE kernels at d_model "
            f"{d_model}: K3/K3b take D in {D_MODELS}")
    plain_routes += 1


# Tokens per step of the plain versions (the JAX loss_chunk_size).
PLAIN_CHUNK = 2048


def _label_logit(g, table, bias, labels):
    """Per-token fp32 logit of its label: g . E[label] + bias[label]."""
    rows = table[labels].float()
    return (g.float() * rows).sum(-1) + bias.float()[labels]


def tied_ce_fwd_plain(g, table, bias, labels, chunk: int = PLAIN_CHUNK):
    """(nll [T] fp32, lse [T] fp32) for logits = g table^T + bias, in
    fp32, `chunk` tokens at a time."""
    table32, bias32 = table.float(), bias.float()
    lse = torch.cat([
        torch.logsumexp(g[i:i + chunk].float() @ table32.T + bias32, dim=-1)
        for i in range(0, g.shape[0], chunk)])
    return lse - _label_logit(g, table, bias, labels), lse


def tied_ce_bwd_plain(g, table, bias, labels, lse, dnll,
                      chunk: int = PLAIN_CHUNK):
    """(dg, dtable, dbias) of sum(nll * dnll), in fp32, `chunk` tokens at a
    time: dlogits = (exp(logits - lse) - onehot(label)) * dnll. Returned in
    the dtypes of g, table and bias."""
    table32, bias32 = table.float(), bias.float()
    dg = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    de = torch.zeros_like(table32)
    db = torch.zeros_like(bias32)
    for i in range(0, g.shape[0], chunk):
        g32 = g[i:i + chunk].float()
        logits = g32 @ table32.T + bias32
        dl = torch.exp(logits - lse[i:i + chunk, None])
        dl[torch.arange(g32.shape[0], device=g.device),
           labels[i:i + chunk]] -= 1.0
        dl *= dnll[i:i + chunk, None].float()
        dg[i:i + chunk] = dl @ table32
        de += dl.T @ g32
        db += dl.sum(0)
    return dg.to(g.dtype), de.to(table.dtype), db.to(bias.dtype)


def _check(g, table, bias, labels):
    if g.ndim != 2 or table.ndim != 2 or g.shape[1] != table.shape[1]:
        raise ValueError(f"g must be [T, D] and table [V, D], got "
                         f"{tuple(g.shape)}, {tuple(table.shape)}")
    if bias.shape != table.shape[:1] or labels.shape != g.shape[:1]:
        raise ValueError(f"bias must be [V] and labels [T], got "
                         f"{tuple(bias.shape)}, {tuple(labels.shape)}")
    if len({t.device for t in (g, table, bias, labels)}) != 1:
        raise ValueError("inputs on several devices")


def _check_cuda(kernel, g, table, bias):
    if g.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise TypeError(f"the {kernel} kernel takes bf16 g and table")
    if bias.dtype != torch.float32:
        raise TypeError(f"the {kernel} kernel takes an fp32 bias")
    if g.shape[1] not in D_MODELS or table.shape[0] % VOCAB_TILE:
        raise ValueError(f"the {kernel} kernel takes D in {D_MODELS} and "
                         f"a vocab that is a multiple of {VOCAB_TILE}, got "
                         f"{tuple(table.shape)}")
    if not all(t.is_contiguous() for t in (g, table, bias)):
        raise ValueError(f"the {kernel} kernel takes contiguous inputs")


def tied_ce_fwd(g, table, bias, labels):
    """K3. g [T, D], table [V, D], bias [V], labels [T] (int) ->
    (nll [T] fp32, lse [T] fp32). CUDA: bf16 g and table, fp32 bias,
    D in D_MODELS, V % 128 == 0, contiguous; the vocab split `fwd_splits`
    ways over the card's SMs."""
    global fwd_launches, fwd_launches_d256
    _check(g, table, bias, labels)
    if not g.is_cuda:
        return tied_ce_fwd_plain(g, table, bias, labels)
    _check_cuda("K3", g, table, bias)
    t, v = g.shape[0], table.shape[0]
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    splits = fwd_splits(t, v, sms)
    lse = torch.empty(t, dtype=torch.float32, device=g.device)
    # Each split's (max, sum) partials, merged in order by the kernel.
    part = torch.empty((splits, t, 2) if splits > 1 else (0,),
                       dtype=torch.float32, device=g.device)
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    code = lib.svt_tied_ce_fwd(g.data_ptr(), table.data_ptr(),
                               bias.data_ptr(), lse.data_ptr(),
                               part.data_ptr(), t, v, g.shape[1], splits,
                               stream)
    cuda_lib.check(code, "tied_ce_fwd")
    if g.shape[1] == 256:
        fwd_launches_d256 += 1
    else:
        fwd_launches += 1
    return lse - _label_logit(g, table, bias, labels), lse


# K3's grid: CTAs of FWD_ROWS tokens, each over VOCAB_TILE-row tiles of a
# 1/splits share of the vocab. A CTA's fixed cost (loading its 128 x D
# of g, filling the pipeline, merging) is about FWD_CTA_COST_TILES tiles'
# time at either width: a tile's products and the g rows both scale with
# D.
FWD_ROWS = 128
FWD_MAX_SPLITS = 16
FWD_CTA_COST_TILES = 2


def fwd_splits(tokens: int, vocab: int, sms: int) -> int:
    """Ways K3 splits the vocab: the power of two (at most FWD_MAX_SPLITS,
    leaving each CTA at least two tiles, one for each of its consumer
    warpgroups) whose grid of ceil(tokens / 128) x splits CTAs, one per SM
    at a time, finishes soonest: waves x (tiles per CTA + a CTA's fixed
    cost). 1 at 16,384 tokens (128 CTAs on 132 SMs), 8 at 25,600, 4 at
    102,400 on an H100's 132 SMs."""
    row_tiles = -(-tokens // FWD_ROWS)
    tiles = vocab // VOCAB_TILE
    best, best_cost = 1, None
    splits = 1
    while splits <= FWD_MAX_SPLITS and tiles % splits == 0 and (
            splits == 1 or tiles // splits >= 2):
        waves = -(-row_tiles * splits // sms)
        cost = waves * (tiles // splits + FWD_CTA_COST_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
        splits *= 2
    return best


def tied_ce_bwd(g, table, bias, labels, lse, dnll):
    """K3b. (dg, dtable, dbias) of sum(nll * dnll) given the forward's lse
    [T] fp32 and dnll [T] fp32, in the dtypes of g, table and bias. CUDA:
    bf16 g and table, fp32 bias, lse and dnll, D in D_MODELS, V % 128 ==
    0, contiguous; the kernels run through `tied_ce_bwd_chunked`."""
    global bwd_launches, bwd_launches_d256
    _check(g, table, bias, labels)
    if lse.shape != labels.shape or dnll.shape != labels.shape:
        raise ValueError("lse and dnll must be [T]")
    if not g.is_cuda:
        return tied_ce_bwd_plain(g, table, bias, labels, lse, dnll)
    _check_cuda("K3b", g, table, bias)
    if table.shape[0] % BWD_TILE:
        raise ValueError(f"the K3b kernels take a vocab that is a multiple "
                         f"of {BWD_TILE}, got {table.shape[0]}")
    if lse.dtype != torch.float32 or dnll.dtype != torch.float32:
        raise TypeError("the K3b kernels take fp32 lse and dnll")
    if not (lse.is_contiguous() and dnll.is_contiguous()):
        raise ValueError("the K3b kernels take contiguous lse and dnll")
    grads = tied_ce_bwd_chunked(g, table, bias, labels, lse, dnll)
    if g.shape[1] == 256:
        bwd_launches_d256 += 1
    else:
        bwd_launches += 1
    return grads


def bwd_chunk(tokens: int, vocab: int,
              scratch_bytes: int = DL_SCRATCH_BYTES) -> int:
    """Tokens per chunk of `tied_ce_bwd_chunked`: the fewest chunks whose
    bf16 logit gradients [C, V] fit in `scratch_bytes`, balanced, C a
    multiple of BWD_TILE (14,720 at T = 102,400, V = 32,768: 7 chunks).
    The scratch holds logit gradients only, so the chunk does not depend
    on D."""
    tiles = -(-tokens // BWD_TILE)
    fit = max(1, scratch_bytes // (BWD_TILE * vocab * 2))
    chunks = -(-tiles // fit)
    return -(-tiles // chunks) * BWD_TILE


def tied_ce_bwd_chunked(g, table, bias, labels, lse, dnll,
                        scratch_bytes: int = DL_SCRATCH_BYTES):
    """K3b as the card computes it, chunk by chunk (`bwd_chunk` tokens).

    For each chunk of tokens, in order: the logit gradients once,
    dl = round((exp(logits - lse) - onehot(label)) * dnll) in g's dtype,
    into a [C, V] scratch (`_bwd_dl`), then dg_c = dl E (`_bwd_dg`) and
    dE += dl^T g_c (`_bwd_de`). dbias sums the unrounded terms' partials
    per 128 tokens, in order (`_bwd_dbias`). dg's terms lack the onehot:
    `_bwd_dl` also gives fix = round(p dnll) - round((p - 1) dnll) at each
    token's label, so dl E + fix E[label] is their sum, and the fp32
    gather below adds fix - dnll times E[label] (the -dnll E[label] term
    of the JAX package's backward). CUDA tensors launch the kernels of
    csrc/tied_ce_bwd.cu; CPU tensors run the same loop on plain products
    in fp32. Returns (dg, dtable, dbias) in the dtypes of g, table and
    bias.
    """
    t, d = g.shape
    v = table.shape[0]
    chunk = bwd_chunk(t, v, scratch_bytes)
    tiles = -(-t // BWD_TILE)
    f32 = {"dtype": torch.float32, "device": g.device}
    dl = torch.empty((chunk, v), dtype=g.dtype, device=g.device)
    part = torch.empty((tiles, v), **f32)
    fix = torch.zeros(t, **f32)
    dg = torch.empty((t, d), **f32)
    de = torch.empty((v, d), **f32)
    db = torch.empty(v, **f32)
    if g.is_cuda:
        # K-major operands for the two gradient products: E^T and g^T,
        # the latter zero-filled to whole token tiles.
        g_t = g.new_empty((d, tiles * BWD_TILE))
        g_t[:, :t] = g.T
        g_t[:, t:] = 0
        table_t = table.T.contiguous()
        kernel_labels = labels.to(torch.int32).contiguous()
    else:
        g_t, table_t, kernel_labels = g.T, table.T, labels
    for c0 in range(0, t, chunk):
        n = min(chunk, t - c0)
        _bwd_dl(g, table, bias, kernel_labels, lse, dnll, dl, part, fix, c0,
                n)
        _bwd_dg(dl, table_t, dg, c0, n)
        _bwd_de(dl, g_t, de, c0, n, t, accumulate=c0 > 0)
    _bwd_dbias(part, db)
    dg += (fix - dnll)[:, None] * table[labels].float()
    return dg.to(g.dtype), de.to(table.dtype), db.to(bias.dtype)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _bwd_dl(g, table, bias, labels, lse, dnll, dl, part, fix, c0, n):
    """Tokens [c0, c0 + n): dl[:n], zero rows up to the next token tile,
    the dbias partials of its token tiles in `part`, and fix[c0:c0 + n]."""
    if g.is_cuda:
        code = cuda_lib.library().svt_tied_ce_bwd_dl(
            g.data_ptr(), table.data_ptr(), bias.data_ptr(), lse.data_ptr(),
            dnll.data_ptr(), labels.data_ptr(), dl.data_ptr(),
            part.data_ptr(), fix.data_ptr(), g.shape[0], table.shape[0],
            g.shape[1], c0, n, dl.shape[0], _stream(g))
        cuda_lib.check(code, "tied_ce_bwd (dl)")
        return
    rows = slice(c0, c0 + n)
    p = torch.exp(g[rows].float() @ table.float().T + bias.float()
                  - lse[rows, None])
    w = dnll[rows, None].float()
    at = (torch.arange(n, device=g.device), labels[rows].long())
    dg_term = (p[at] * w[:, 0]).to(dl.dtype).float()
    p[at] -= 1.0
    p *= w
    rounded = p.to(dl.dtype)
    fix[rows] = dg_term - rounded[at].float()
    padded = -(-n // BWD_TILE) * BWD_TILE
    dl[:n] = rounded
    dl[n:padded] = 0
    sums = torch.cat([p, p.new_zeros((padded - n, p.shape[1]))]).view(
        -1, BWD_TILE, p.shape[1]).sum(1)
    part[c0 // BWD_TILE:c0 // BWD_TILE + sums.shape[0]] = sums


def _bwd_dg(dl, table_t, dg, c0, n):
    """dg[c0:c0 + n] = dl[:n] E, with table_t = E^T [D, V]."""
    if dl.is_cuda:
        code = cuda_lib.library().svt_tied_ce_bwd_dg(
            dl.data_ptr(), table_t.data_ptr(), dg.data_ptr(), dg.shape[0],
            table_t.shape[1], dg.shape[1], c0, n, dl.shape[0], _stream(dl))
        cuda_lib.check(code, "tied_ce_bwd (dg)")
        return
    dg[c0:c0 + n] = dl[:n].float() @ table_t.T.float()


def _bwd_de(dl, g_t, de, c0, n, tokens, accumulate):
    """dE = (or +=, when accumulate) dl[:n]^T g[c0:c0 + n], with g_t = g^T
    [D, >= tokens]."""
    if dl.is_cuda:
        code = cuda_lib.library().svt_tied_ce_bwd_de(
            dl.data_ptr(), g_t.data_ptr(), de.data_ptr(), tokens,
            g_t.shape[1], de.shape[0], de.shape[1], c0, n, dl.shape[0],
            int(accumulate), _stream(dl))
        cuda_lib.check(code, "tied_ce_bwd (dE)")
        return
    prod = dl[:n].float().T @ g_t[:, c0:c0 + n].T.float()
    if accumulate:
        de += prod
    else:
        de.copy_(prod)


def _bwd_dbias(part, db):
    """dbias = the token tiles' partials summed in order."""
    if part.is_cuda:
        code = cuda_lib.library().svt_tied_ce_bwd_dbias(
            part.data_ptr(), db.data_ptr(), part.shape[0], part.shape[1],
            _stream(part))
        cuda_lib.check(code, "tied_ce_bwd (dbias)")
        return
    db.copy_(part.sum(0))


class FusedTiedCrossEntropy(torch.autograd.Function):
    """Per-token NLL of logits = g table^T + bias: K3 forward and K3b
    backward for CUDA tensors, the plain versions for CPU tensors.
    Differentiable in g, table and bias; labels (0 = pad) are not masked
    here, the caller masks."""

    @staticmethod
    def forward(ctx, g, table, bias, labels):
        nll, lse = tied_ce_fwd(g, table, bias, labels)
        ctx.save_for_backward(g, table, bias, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        g, table, bias, labels, lse = ctx.saved_tensors
        dg, de, db = tied_ce_bwd(g, table, bias, labels, lse,
                                 dnll.float().contiguous())
        return dg, de, db, None

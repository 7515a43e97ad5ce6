"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the serving engine on the card. Every test here carries the
`gpu` marker and skips itself without a card.

This file imports torch and the port only (no jax), so on the card it runs
without the JAX set-up of tests/conftest.py: `python -m pytest
tests/test_torch_cuda.py -q -m gpu --noconftest`. Tolerances as in chip_smoke.py:
K1's out in bf16 (both sides round the softmax weights and the output to
bf16, in other summation orders), its lse in fp32 up to summation order;
K4's tokens
identical except on rows whose bisection mass sat within rounding of the
target, and bit for bit across two calls. K2's and K3b's gradients in bf16 against their fp32 plain
versions relative to the largest entry (1e-2: one bf16 rounding of each
output, and K3b's rounding of the logit gradients to bf16 before its
products); K3's lse in fp32 up to summation order over 32,768 logits
(1e-4 absolute). K2 and K3 must also repeat bit for bit. K5 and K5b (the packed layout) as K1 and K2, K5b also
bit for bit across two calls. K6 (the sequence-parallel shard attention:
one K1 launch and one K2 launch set with q_off and the broadcast [CLS]
block as a slot of its own) as K1 and K2, on both branches, bit for bit
across two calls. The evaluation paths (the IWAE estimator and the DReG
step) as chip_smoke.py's eval and dreg phases hold them, at smaller
shapes.
"""
import pytest
import torch

from sparse_vae_tpu_torch.models.generation import SamplingParams, gumbel_noise
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.ops import (ce_kernel, select_kernel, sp_kernel,
                                      swa_kernel)
from sparse_vae_tpu_torch.ops.attention import Attention
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    SlidingWindowAttentionPackedFn, sliding_window_attention,
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)
from sparse_vae_tpu_torch.server import ServeEngine

GRAD_REL = 1e-2


def _assert_rel(got, want, name):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= GRAD_REL * scale, f"{name}: {err:.3g} vs max {scale:.3g}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_kernel_matches_plain(cuda, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(window)
    q, k, v = (torch.randn((2, 8, 640, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor([640, 300], dtype=torch.int32, device=cuda)
    mask = torch.arange(640, device=cuda)[None, :] < lengths[:, None]
    before = swa_kernel.launches
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, window_size=window,
                                  causal=causal)
    assert swa_kernel.launches == before + 1
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, mask, window_size=window, causal=causal, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_kernel_without_cls_matches_plain(cuda, causal, window):
    """K1 with include_cls off (the encoder's bidirectional layers and the
    causal band alone) against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(40 + window + causal)
    q, k, v = (torch.randn((2, 4, 640, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor([640, 450], dtype=torch.int32, device=cuda)
    mask = torch.arange(640, device=cuda)[None, :] < lengths[:, None]
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, window_size=window,
                                  causal=causal, include_cls=False)
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, mask, window_size=window, causal=causal, include_cls=False,
        return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("include_cls", [True, False])
def test_swa_kernel_ragged_rows(cuda, causal, include_cls):
    """K1 on ragged rows: a full row, one shorter than a block and a filler
    row of length 0 (out 0, lse -inf, no NaN), against the plain version
    on every row that sees a key."""
    gen = torch.Generator(device=cuda).manual_seed(50 + causal)
    q, k, v = (torch.randn((3, 4, 512, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor([512, 70, 0], dtype=torch.int32, device=cuda)
    mask = torch.arange(512, device=cuda)[None, :] < lengths[:, None]
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, causal=causal,
                                  include_cls=include_cls)
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, mask, causal=causal, include_cls=include_cls,
        return_lse=True)
    assert not bool(torch.isnan(out.float()).any())
    assert bool((out[2] == 0).all())
    assert bool(torch.isneginf(lse[2]).all())
    seen = torch.isfinite(ref_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3,
                               rtol=1e-5)


@pytest.mark.gpu
def test_swa_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 128, 64), device=cuda)
    lengths = torch.full((1,), 128, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        swa_kernel.swa_fwd(q, q, q, lengths)               # fp32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd(qb, qb, qb, lengths, block_size=64)
    qt = qb.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd(qt, qt, qt, lengths)            # not contiguous


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_p", [0.9, 1.0, 1e-3])
@pytest.mark.parametrize("with_noise", [True, False])
@pytest.mark.parametrize("vocab", [512, 32768, 50000])
@pytest.mark.parametrize("rows", [1, 64, 133, 512])
def test_select_kernel_matches_plain(cuda, rows, vocab, with_noise, top_p,
                                     temperature):
    """K4 on both of its instantiations (a row over a cluster of two CTAs
    at 1 and 64 rows, one CTA a row at 133 and 512; V = 50,000 always
    takes the cluster), with the nucleus on,
    off (top_p 1) and down to the max alone (1e-3): two calls give the
    same choices bit for bit, and they are the plain version's on every
    row whose margin is above 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(7 * rows + vocab)
    s = 4.0 * torch.randn((rows, vocab), generator=gen, device=cuda)
    noise = gumbel_noise(s.shape, gen) if with_noise else None
    kw = {"top_p": top_p, "temperature": temperature}
    got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    again = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    assert torch.equal(got, again)
    want, _, margin = select_kernel.select_rows_plain(s, noise, **kw)
    held = margin > 1e-4
    assert torch.equal(got[held], want[held])
    if noise is None and top_p == 1.0:
        assert torch.equal(got, s.argmax(dim=-1))


@pytest.mark.gpu
@pytest.mark.parametrize("num_iters", [0, 8, 20, 30])
@pytest.mark.parametrize("vocab", [32768, 50000])
@pytest.mark.parametrize("rows", [64, 512])
def test_select_kernel_takes_any_num_iters(cuda, rows, vocab, num_iters):
    """Fewer steps than 24 end inside a level (20: 8 + 8 + 4) or take
    none (0: every token kept); past 24 the fp32 mid rounds and the kernel
    runs plain bisection steps. Each as the plain version, bit for bit
    across two calls, on both instantiations (a cluster at 64 rows and
    at V = 50,000, one CTA a row at 512 rows of 32,768)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + vocab + num_iters)
    s = 4.0 * torch.randn((rows, vocab), generator=gen, device=cuda)
    noise = gumbel_noise(s.shape, gen)
    got = select_kernel.nucleus_gumbel_argmax(s, noise, num_iters=num_iters)
    again = select_kernel.nucleus_gumbel_argmax(s, noise,
                                                num_iters=num_iters)
    assert torch.equal(got, again)
    want, _, margin = select_kernel.select_rows_plain(s, noise,
                                                      num_iters=num_iters)
    held = margin > 1e-4
    assert torch.equal(got[held], want[held])


@pytest.mark.gpu
@pytest.mark.parametrize("top_p", [0.9, 1.0])
@pytest.mark.parametrize("vocab", [32768, 50000])
@pytest.mark.parametrize("rows", [1, 512])
def test_select_kernel_gives_index_0_when_every_value_is_minus_inf(
        cuda, rows, vocab, top_p):
    """-inf noise on every token of the even rows, the kept ones included:
    every val there is -inf and the choice is index 0, as in
    _select_tile; the odd rows are ordinary. On both instantiations (a
    cluster at 1 row and at V = 50,000, one CTA a row at 512 rows of
    32,768)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + vocab)
    s = 4.0 * torch.randn((rows, vocab), generator=gen, device=cuda)
    noise = gumbel_noise(s.shape, gen)
    noise[::2] = float("-inf")
    got = select_kernel.nucleus_gumbel_argmax(s, noise, top_p=top_p)
    want, _, margin = select_kernel.select_rows_plain(s, noise, top_p=top_p)
    assert bool((want[::2] == 0).all()) and bool((got[::2] == 0).all())
    held = margin > 1e-4
    assert torch.equal(got[held], want[held])


@pytest.mark.gpu
def test_select_kernel_rejects_what_it_does_not_take(cuda):
    s = torch.zeros((2, 512), device=cuda)
    with pytest.raises(TypeError):
        select_kernel.nucleus_gumbel_argmax(s.double())
    with pytest.raises(ValueError):
        select_kernel.nucleus_gumbel_argmax(s[:, :510])    # not contiguous
    flat = torch.zeros(2 * 512 + 1, device=cuda)
    with pytest.raises(ValueError):
        select_kernel.nucleus_gumbel_argmax(flat[1:].view(2, 512))
    with pytest.raises(ValueError):
        select_kernel.nucleus_gumbel_argmax(torch.zeros((1, 60000),
                                                        device=cuda))


@pytest.mark.gpu
def test_engine_serves_on_the_card(cuda):
    """A tiny bf16 model with the r5 head geometry (Dh 64, block 128) on
    the card: prompts of >= 128 tokens go through K1, decoding through K4."""
    torch.manual_seed(0)
    hp = TransformerVAEHparams(d_model=128, num_heads=2, num_layers=2,
                               latent_depth=8, vocab_size=512,
                               attn_window_size=2, attn_block_size=128)
    model = TransformerVAE(hp).to(cuda, torch.bfloat16).eval()
    engine = ServeEngine(model, batch_size=4, max_length=512,
                         sampling=SamplingParams(), slice_steps=16,
                         fused_select=True, end_token=-1)
    k1, k4 = swa_kernel.launches, select_kernel.launches
    try:
        prompt = list(range(3, 203))
        outs = [engine.generate(20, seed=i,
                                prompt_tokens=prompt if i % 2 else None,
                                timeout=300) for i in range(4)]
    finally:
        engine.shutdown()
    for i, out in enumerate(outs):
        assert len(out) == (200 if i % 2 else 0) + 20
    assert swa_kernel.launches > k1 and select_kernel.launches > k4


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_bwd_kernel_matches_plain(cuda, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(10 + window)
    q, k, v, do = (torch.randn((2, 4, 1024, 64), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    lengths = torch.tensor([1024, 333], dtype=torch.int32, device=cuda)
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, window_size=window,
                                  causal=causal)
    before = swa_kernel.bwd_launches
    got = swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                             window_size=window, causal=causal)
    assert swa_kernel.bwd_launches == before + 1
    want = sliding_window_attention_bwd_plain(
        q, k, v, lengths, lse, out, do, window_size=window, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g.float()).all())
        _assert_rel(g, w, "d" + name)


@pytest.mark.gpu
@pytest.mark.parametrize("include_cls", [True, False])
def test_swa_bwd_kernel_repeats_on_ragged_rows(cuda, include_cls):
    """K2 on rows of 129, 3001 and 4096 valid keys: two calls on the same
    inputs give bit-identical gradients (no atomics, fixed summation
    orders), and they match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(40 + include_cls)
    q, k, v, do = (torch.randn((3, 4, 4096, 64), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    lengths = torch.tensor([129, 3001, 4096], dtype=torch.int32,
                           device=cuda)
    kw = {"include_cls": include_cls}
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
    got = swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do, **kw)
    again = swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, lse, out,
                                              do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g.float()).all())
        _assert_rel(g, w, "d" + name)


@pytest.mark.gpu
@pytest.mark.parametrize("q_off", [0, 1])
def test_swa_bwd_kernel_rows_without_a_valid_key(cuda, q_off):
    """K2 without the [CLS] slot, where short rows leave whole query
    blocks with no valid key (lse -inf): their dq rows are exactly 0 and
    nothing is NaN; with q_off = 0 and with q_off > 0 (K6's band
    backward), against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(50 + q_off)
    q, do = (torch.randn((3, 4, 1024, 64), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((3, 4, 1024 + 128 * q_off, 64), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([200, 0, 1024 + 128 * q_off], dtype=torch.int32,
                           device=cuda)
    kw = {"include_cls": False, "q_off": q_off}
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
    empty = torch.isinf(lse)
    assert bool(empty[0].any()) and bool(empty[1].all())
    dq, dk, dv = swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do, **kw)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, lse, out,
                                              do, **kw)
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        assert bool(torch.isfinite(g.float()).all()), name
        _assert_rel(g, w, "d" + name)
    assert bool((dq[empty] == 0).all())
    assert bool((dk[1] == 0).all()) and bool((dv[1] == 0).all())


@pytest.mark.gpu
def test_attention_on_the_card_has_a_gradient(cuda):
    """The sparse attention's output on the card carries a grad_fn, and
    backward() gives q, k and v the K2 gradients: non-zero and equal to
    the plain backward's."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 8, 512, 64), generator=gen, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    mask = torch.arange(512, device=cuda)[None, :] < torch.tensor(
        [[512], [200]], device=cuda)
    out = sliding_window_attention(q, k, v, mask)
    assert out.grad_fn is not None
    do = torch.randn(out.shape, generator=gen, device=cuda).to(out.dtype)
    before = swa_kernel.bwd_launches
    out.backward(do)
    assert swa_kernel.bwd_launches == before + 1
    lengths = mask.sum(-1, dtype=torch.int32)
    with torch.no_grad():
        o, lse = swa_kernel.swa_fwd(q, k, v, lengths)
        want = sliding_window_attention_bwd_plain(q, k, v, lengths, lse, o,
                                                  do)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
        _assert_rel(t.grad, w, "d" + name)


@pytest.mark.gpu
def test_tied_ce_kernels_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    t, v = 1000, 32768                      # t is not a tile multiple
    g = (0.5 * torch.randn((t, 512), generator=gen, device=cuda)).to(
        torch.bfloat16)
    table = (0.5 * torch.randn((v, 512), generator=gen, device=cuda)).to(
        torch.bfloat16)
    bias = torch.randn(v, generator=gen, device=cuda)
    labels = torch.randint(0, v, (t,), generator=gen, device=cuda)
    dnll = torch.rand(t, generator=gen, device=cuda)
    f0, b0 = ce_kernel.fwd_launches, ce_kernel.bwd_launches
    nll, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    got = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    assert (ce_kernel.fwd_launches, ce_kernel.bwd_launches) == (f0 + 1,
                                                               b0 + 1)
    want_nll, want_lse = ce_kernel.tied_ce_fwd_plain(g, table, bias, labels)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=0)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, want_lse, dnll)
    for name, a, b in zip(("dg", "dE", "dbias"), got, want):
        _assert_rel(a, b, name)


@pytest.mark.gpu
@pytest.mark.parametrize("t,vocab", [(1000, 32768), (16383, 32768),
                                     (1000, 1024), (16383, 2048)])
def test_tied_ce_fwd_kernel_repeats_and_matches_plain(cuda, t, vocab):
    """K3 at token counts that are no multiple of its 128-token tile and
    fill at most one wave of 132 CTAs without a vocab split (16,383 <=
    128 x 132), at V = 32,768 and at smaller vocabs inside the gate
    (V % 1024 == 0), with and without the vocab split (1,000 tokens
    split 16 or 4 ways): two calls give bit-identical lse and nll, and
    both match the fp32 plain version."""
    gen = torch.Generator(device=cuda).manual_seed(t + vocab)
    g = torch.randn((t, 512), generator=gen, device=cuda).to(torch.bfloat16)
    table = (0.05 * torch.randn((vocab, 512), generator=gen, device=cuda)
             ).to(torch.bfloat16)
    bias = 0.1 * torch.randn(vocab, generator=gen, device=cuda)
    labels = torch.randint(0, vocab, (t,), generator=gen, device=cuda)
    nll, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    nll2, lse2 = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    want_nll, want_lse = ce_kernel.tied_ce_fwd_plain(g, table, bias, labels)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=0)


def _ce_problem(cuda, t, v, padded, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = (0.5 * torch.randn((t, 512), generator=gen, device=cuda)).to(
        torch.bfloat16)
    table = (0.5 * torch.randn((v, 512), generator=gen, device=cuda)).to(
        torch.bfloat16)
    bias = torch.randn(v, generator=gen, device=cuda)
    labels = torch.randint(0, v, (t,), generator=gen, device=cuda)
    dnll = torch.rand(t, generator=gen, device=cuda)
    labels[t - padded:] = 0                 # padding tokens: dnll 0
    dnll[t - padded:] = 0.0
    return g, table, bias, labels, dnll


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [1024, 32768])
def test_tied_ce_bwd_kernels_match_plain_and_repeat(cuda, vocab):
    """K3b at a token count that is no multiple of the 128-token tile,
    with padding tokens, against its fp32 plain version; two calls on the
    same inputs give bit-identical gradients."""
    g, table, bias, labels, dnll = _ce_problem(cuda, 1000, vocab, 100,
                                               60 + vocab)
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    before = ce_kernel.bwd_launches
    got = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    again = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    assert ce_kernel.bwd_launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, lse, dnll)
    for name, a, b in zip(("dg", "dE", "dbias"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        _assert_rel(a, b, name)


@pytest.mark.gpu
def test_tied_ce_bwd_kernels_over_several_chunks(cuda):
    """K3b's kernels over several token chunks with a partial last one
    (a small scratch bound), against the one-chunk call: dE sums its
    chunks in order, dg and dbias take each chunk's rows."""
    g, table, bias, labels, dnll = _ce_problem(cuda, 3000, 2048, 37, 70)
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    one = ce_kernel.tied_ce_bwd_chunked(g, table, bias, labels, lse, dnll)
    # 1024 tokens a chunk: 3 chunks, the last of 952.
    several = ce_kernel.tied_ce_bwd_chunked(g, table, bias, labels, lse,
                                            dnll, scratch_bytes=1024 * 2048 * 2)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, lse, dnll)
    for name, a, b, w in zip(("dg", "dE", "dbias"), several, one, want):
        _assert_rel(a, w, name)
        torch.testing.assert_close(a.float(), b.float(), atol=1e-5,
                                   rtol=1e-2)


@pytest.mark.gpu
def test_ce_kernels_reject_what_they_do_not_take(cuda):
    g = torch.zeros((64, 512), device=cuda)
    table = torch.zeros((128, 512), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(128, device=cuda)
    labels = torch.zeros(64, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError):
        ce_kernel.tied_ce_fwd(g, table, bias, labels)          # fp32 g
    gb = g.to(torch.bfloat16)
    with pytest.raises(ValueError):
        ce_kernel.tied_ce_fwd(gb, table[:100], bias[:100], labels)  # V % 64
    with pytest.raises(ValueError):
        ce_kernel.tied_ce_fwd(gb[:, :256].contiguous(),
                              table[:, :256].contiguous(), bias, labels)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2])
def test_swa_packed_kernels_match_plain(cuda, heads, causal, window):
    """K5 and K5b on packed [B, L, H * 128] operands against their plain
    versions; two and four heads, so a head-offset fault cannot hide."""
    gen = torch.Generator(device=cuda).manual_seed(20 + window + heads)
    q, k, v, do = (torch.randn((2, 640, heads * 128), generator=gen,
                               device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    lengths = torch.tensor([640, 300], dtype=torch.int32, device=cuda)
    f0, b0 = swa_kernel.packed_launches, swa_kernel.packed_bwd_launches
    out, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads,
                                         window_size=window, causal=causal)
    got = swa_kernel.swa_bwd_packed(q, k, v, lengths, lse, out, do, heads,
                                    window_size=window, causal=causal)
    assert (swa_kernel.packed_launches,
            swa_kernel.packed_bwd_launches) == (f0 + 1, b0 + 1)
    ref, ref_lse = sliding_window_attention_packed_plain(
        q, k, v, lengths, heads, window_size=window, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    want = sliding_window_attention_packed_bwd_plain(
        q, k, v, lengths, lse, out, do, heads, window_size=window,
        causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g.float()).all())
        _assert_rel(g, w, "d" + name)


@pytest.mark.gpu
def test_packed_attention_on_the_card_has_a_gradient(cuda):
    """The packed Function's output on the card carries a grad_fn, and
    backward() gives q, k and v K5b's gradients, equal to the plain
    backward's."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 512, 4 * 128), generator=gen, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    lengths = torch.tensor([512, 200], dtype=torch.int32, device=cuda)
    out = SlidingWindowAttentionPackedFn.apply(q, k, v, lengths, 4, 2, 128,
                                               True, True)
    assert out.grad_fn is not None
    do = torch.randn(out.shape, generator=gen, device=cuda).to(out.dtype)
    before = swa_kernel.packed_bwd_launches
    out.backward(do)
    assert swa_kernel.packed_bwd_launches == before + 1
    with torch.no_grad():
        o, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, 4)
        want = sliding_window_attention_packed_bwd_plain(q, k, v, lengths,
                                                         lse, o, do, 4)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
        _assert_rel(t.grad, w, "d" + name)


@pytest.mark.gpu
def test_swa_packed_kernel_rejects_what_it_does_not_take(cuda):
    lengths = torch.full((1,), 128, dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 128, 2 * 128), device=cuda)
    with pytest.raises(TypeError):
        swa_kernel.swa_fwd_packed(q, q, q, lengths, 2)          # fp32
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd_packed(qb, qb, qb, lengths, 4)       # Dh 64


@pytest.mark.gpu
def test_plain_routes_raise_on_the_card(cuda):
    """A sparse attention at Dh = 32 and a tied loss at D = 256 lie inside
    the JAX package's kernel gates but have no CUDA instantiation: on the
    card they raise instead of running the plain version."""
    narrow = Attention(64, 2, causal=True, sparse=True).to(cuda)
    with pytest.raises(NotImplementedError, match="head_dim 32"):
        narrow(torch.zeros((1, 128, 64), device=cuda))
    hp = TransformerVAEHparams(d_model=256, num_heads=2, num_layers=1,
                               latent_depth=16, vocab_size=1024,
                               num_encoder_latents=8)
    model = TransformerVAE(hp).to(cuda)
    with pytest.raises(NotImplementedError, match="d_model 256"):
        model.sequence_nll(torch.zeros((1, 256, 256), device=cuda),
                           torch.ones((1, 256), dtype=torch.int64,
                                      device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_kernels_with_q_off_match_plain(cuda, window):
    """K1/K2 over extended keys (q_off = window - 1, no [CLS] slot), the
    band part of K6, against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(20 + window)
    q_off = window - 1
    q, do = (torch.randn((2, 4, 512, 64), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 4, 512 + 128 * q_off, 64), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([512 + 128 * q_off, 300], dtype=torch.int32,
                           device=cuda)
    before = (swa_kernel.launches, swa_kernel.sp_launches)
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, window_size=window,
                                  include_cls=False, q_off=q_off)
    # Called directly, K1 counts as K1; only K6 counts its launches as
    # K6's.
    assert (swa_kernel.launches, swa_kernel.sp_launches) == (
        before[0] + 1, before[1])
    mask = torch.arange(k.shape[2], device=cuda)[None, :] < lengths[:, None]
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, mask, window_size=window, include_cls=False,
        return_lse=True, q_off=q_off)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=1e-5)
    got = swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                             window_size=window, include_cls=False,
                             q_off=q_off)
    want = sliding_window_attention_bwd_plain(
        q, k, v, lengths, lse, out, do, window_size=window,
        include_cls=False, q_off=q_off)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        _assert_rel(g, w, "d" + name)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 1024])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_sp_kernel_matches_plain(cuda, start, window):
    """K6 on both branches (start 0: K1/K2 unchanged on the local keys;
    start > 0: q_off and the broadcast [CLS] slot), with ragged rows and a
    filler row (no valid key: out 0, zero gradients, no NaN), through the
    autograd Function, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(30 + window + start)
    S, ctx = 512, 128 * (window - 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, do = randn(3, 4, S, 64), randn(3, 4, S, 64)
    k_ext, v_ext = randn(3, 4, ctx + S, 64), randn(3, 4, ctx + S, 64)
    cls_k, cls_v = randn(3, 4, 128, 64), randn(3, 4, 128, 64)
    full = S if start == 0 else ctx + S
    ext_len = torch.tensor([full, full // 2, 0], dtype=torch.int32,
                           device=cuda)
    cls_len = torch.tensor([128, 100, 0], dtype=torch.int32, device=cuda)
    leaves = [t.clone().requires_grad_()
              for t in (q, k_ext, v_ext, cls_k, cls_v)]
    counts = (swa_kernel.launches, swa_kernel.sp_launches,
              swa_kernel.bwd_launches, swa_kernel.sp_bwd_launches)
    out = sp_kernel.sp_windowed_attention(*leaves, start, ext_len, cls_len,
                                          window, 128)
    out.backward(do)
    banded = start > 0
    assert (swa_kernel.launches, swa_kernel.sp_launches,
            swa_kernel.bwd_launches, swa_kernel.sp_bwd_launches) == (
        counts[0] + (not banded), counts[1] + banded,
        counts[2] + (not banded), counts[3] + banded)
    args = (q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len)
    ref, _ = sp_kernel.sp_fwd_plain(*args, window, 128)
    torch.testing.assert_close(out.detach().float(), ref.float(),
                               atol=2e-2, rtol=2e-2)
    _, lse = sp_kernel.sp_fwd(*args, window, 128)
    want = sp_kernel.sp_bwd_plain(*args, out.detach(), lse, do, window, 128)
    for name, t, w in zip(("dq", "dk_ext", "dv_ext", "dcls_k", "dcls_v"),
                          leaves, want):
        assert bool(torch.isfinite(t.grad.float()).all()), name
        assert bool((t.grad[2] == 0).all()), name      # the filler row
        if w.abs().max() > 0:
            _assert_rel(t.grad, w, name)
        else:
            assert bool((t.grad == 0).all()), name
    assert bool((out[2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_bwd_packed_kernel_repeats_on_ragged_rows(cuda, heads, causal,
                                                      window):
    """K5b (K2's kernels at Dh = 128 on the packed layout) on rows of
    1280, 1000, 129, 1 and 0 valid keys: two calls give bit-identical
    gradients, they match the plain version, a row with no valid key
    gets zero gradients, and nothing is NaN."""
    gen = torch.Generator(device=cuda).manual_seed(60 + 2 * window + causal
                                                   + heads)
    q, k, v, do = (torch.randn((5, 1280, heads * 128), generator=gen,
                               device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    lengths = torch.tensor([1280, 1000, 129, 1, 0], dtype=torch.int32,
                           device=cuda)
    kw = {"window_size": window, "causal": causal}
    out, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads, **kw)
    before = swa_kernel.packed_bwd_launches
    got = swa_kernel.swa_bwd_packed(q, k, v, lengths, lse, out, do, heads,
                                    **kw)
    again = swa_kernel.swa_bwd_packed(q, k, v, lengths, lse, out, do, heads,
                                      **kw)
    assert swa_kernel.packed_bwd_launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = sliding_window_attention_packed_bwd_plain(
        q, k, v, lengths, lse, out, do, heads, **kw)
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g.float()).all()), name
        _assert_rel(g, w, "d" + name)
    for g in got:
        assert bool((g[4] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("cls_len", [128, 77, 0])
def test_sp_banded_backward_folds_cls_into_k2(cuda, cls_len):
    """K6's backward on a banded shard at start 8192 is one K2 launch with
    the broadcast [CLS] block as a slot: all five gradients against the
    plain version (JAX's composition), with a full, a partial or no [CLS]
    beside a filler row (no valid key: zero gradients, no NaN), and bit
    for bit across two calls."""
    gen = torch.Generator(device=cuda).manual_seed(70 + cls_len)
    S, ctx, start = 1024, 128, 8192

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, do = randn(3, 4, S, 64), randn(3, 4, S, 64)
    k_ext, v_ext = randn(3, 4, ctx + S, 64), randn(3, 4, ctx + S, 64)
    cls_k, cls_v = randn(3, 4, 128, 64), randn(3, 4, 128, 64)
    ext_len = torch.tensor([ctx + S, 700, 0], dtype=torch.int32, device=cuda)
    cls_lens = torch.tensor([cls_len, 128, 0], dtype=torch.int32,
                            device=cuda)
    args = (q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_lens)
    out, lse = sp_kernel.sp_fwd(*args, 2, 128)
    before = (swa_kernel.bwd_launches, swa_kernel.sp_bwd_launches)
    got = sp_kernel.sp_bwd(*args, out, lse, do, 2, 128)
    again = sp_kernel.sp_bwd(*args, out, lse, do, 2, 128)
    assert (swa_kernel.bwd_launches, swa_kernel.sp_bwd_launches) == (
        before[0], before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = sp_kernel.sp_bwd_plain(*args, out, lse, do, 2, 128)
    for name, g, w in zip(("dq", "dk_ext", "dv_ext", "dcls_k", "dcls_v"),
                          got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        assert bool((g[2] == 0).all()), name
        _assert_rel(g, w, name)
    if cls_len == 0:
        assert bool((got[3][0] == 0).all()) and bool((got[4][0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("cls_len", [128, 77, 0])
def test_swa_fwd_broadcast_cls_matches_plain(cuda, window, cls_len):
    """K1's broadcast instantiation (K6's banded forward, q_off = window
    - 1, 0 at window 1) on ragged rows: a full row, a short one, a row
    with one valid key and a filler row (no valid key: out 0, lse -inf, no
    NaN), against the plain version (the band, the [CLS] block attended
    apart, merged by logaddexp); two calls bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(80 + window + cls_len)
    S, q_off = 1024, window - 1
    ctx = 128 * q_off

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q = randn(4, 4, S, 64)
    k, v = randn(4, 4, ctx + S, 64), randn(4, 4, ctx + S, 64)
    cls = (randn(4, 4, 128, 64), randn(4, 4, 128, 64),
           torch.tensor([cls_len, 128, 0, 0], dtype=torch.int32,
                        device=cuda))
    lengths = torch.tensor([ctx + S, 700, 1, 0], dtype=torch.int32,
                           device=cuda)
    kw = {"window_size": window, "include_cls": False, "q_off": q_off,
          "cls": cls}
    before = (swa_kernel.launches, swa_kernel.sp_launches)
    out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
    again, lse2 = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
    assert (swa_kernel.launches, swa_kernel.sp_launches) == (
        before[0] + 2, before[1])
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    mask = torch.arange(k.shape[2], device=cuda)[None, :] < lengths[:, None]
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, mask, window_size=window, include_cls=False,
        return_lse=True, q_off=q_off, cls=cls)
    assert not bool(torch.isnan(out.float()).any())
    assert bool((out[3] == 0).all()) and bool(torch.isneginf(lse[3]).all())
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_swa_fwd_packed_kernel_on_ragged_rows(cuda, heads, causal, window):
    """K5 (the forward's Dh = 128 packed instantiation) on rows of 1280,
    1000, 129, 1 and 0 valid keys against its plain version; the row with
    no valid key gives out 0 and lse -inf, nothing is NaN, and two calls
    agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(90 + 2 * window + causal
                                                   + heads)
    q, k, v = (torch.randn((5, 1280, heads * 128), generator=gen,
                           device=cuda).to(torch.bfloat16) for _ in range(3))
    lengths = torch.tensor([1280, 1000, 129, 1, 0], dtype=torch.int32,
                           device=cuda)
    kw = {"window_size": window, "causal": causal}
    before = swa_kernel.packed_launches
    out, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads, **kw)
    again, lse2 = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads, **kw)
    assert swa_kernel.packed_launches == before + 2
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    ref, ref_lse = sliding_window_attention_packed_plain(
        q, k, v, lengths, heads, **kw)
    assert not bool(torch.isnan(out.float()).any())
    assert bool((out[4] == 0).all()) and bool(torch.isneginf(lse[4]).all())
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=1e-3,
                               rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["real-prose-vae-r5", "real-prose-pg19-fb8"])
def test_iwae_through_the_kernels_matches_plain(cuda, run):
    """chip_smoke.py's eval phase at [2, 4096] ragged, 4 samples in 2
    chunks, on the run's trained weights: the IWAE NLL per token through
    K1 and K3 within 0.1% of the plain versions, the plain run with the
    EVAL_CUTS band block dropped 1% or more away, K1 once a layer and K3
    once a chunk."""
    import chip_smoke
    stats = chip_smoke.eval_phase(run, [4096, 3001], 4, 2, "pytest", "eval")
    assert stats["nll_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert stats["launches"]["tied_ce_fwd"] == 2


@pytest.mark.gpu
def test_dreg_step_through_the_kernels_matches_plain(cuda):
    """chip_smoke.py's dreg phase at [2, 4096] ragged with K = 2: K3/K3b
    alone on a per-sample, per-document dnll, then r5's DReG step through
    K1, K2, K3 and K3b against the fp32 plain step (loss within 0.1%,
    gradients at cosine >= 0.99 or the near-zero rule)."""
    import chip_smoke
    stats = chip_smoke.dreg_phase("pytest", lengths=[4096, 3001], samples=2,
                                  timed_steps=1)
    assert stats["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert stats["launches"]["tied_ce_bwd"] == 1
    assert max(stats["nonuniform_ce"]["rel_errs_dg_dE_dbias"]) <= (
        chip_smoke.GRAD_REL_TOL)


@pytest.mark.gpu
def test_fit_on_bucketed_documents_at_r5_width(cuda, tmp_path):
    """chip_smoke.py's fit phase at 2 decoder layers on 60 documents: r5's
    width and data hparams, 6 steps of Trainer.fit on bucketed groups
    through K1, K2, K3 and K3b (launch counts from the groups and
    validation batches fed), the checkpoint restored bit for bit and one
    step from it equal to the same step from the saved state, and the
    exported archive serving the trained model's logits; then, on r5's
    trained weights at full depth, the first step of each group shape fed
    against the fp32 plain step (loss within 0.1%, gradients at cosine
    >= 0.99), and validation through the kernels within 0.1% of the plain
    versions on documents that repeat a segment, where a band without its
    older block moves val_nll by 1% or more; then the `test` entry on
    the run's checkpoint and corpus (test_entry_phase: a finite, positive
    average, K1 and K3 once a layer and once a chunk of every batch; each
    of its batch shapes held against the plain versions on r5's trained
    weights, the NLL within 0.1%, a band without its older block 1% or
    more away). Every check raises inside the phase."""
    import chip_smoke
    logs = tmp_path / "sparse-vae-logs"
    stats = chip_smoke.fit_r5_phase("pytest", depth=2, n_docs=60,
                                    log_root=logs)
    assert stats["steps"] == chip_smoke.FIT_STEPS
    assert stats["resume"]["bit_identical"]
    assert stats["archive"]["logits_equal"]
    assert [g["group"] for g in stats["groups_against_plain"]] == [
        list(shape) for shape in stats["shapes_fed"]]
    val = stats["validate_against_plain"]
    assert val["val_nll_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert val["band_cut_rel_change"] >= (chip_smoke.VAL_POWER
                                          * chip_smoke.TRAIN_LOSS_RTOL)
    entry = chip_smoke.test_entry_phase("pytest", logs, n_docs=60)
    assert entry["average"] > 0 and entry["launches"]["swa_fwd"] == (
        2 * chip_smoke.TEST_ITERS * entry["batches"])
    held = entry["against_plain"]
    assert len(held["nll_rel_err"]) == entry["batches"]
    assert max(held["nll_rel_err"]) <= chip_smoke.TRAIN_LOSS_RTOL

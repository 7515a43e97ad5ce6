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
shapes. K3/K3b at the Transformer LM's D = 256 as at 512, and the dense
causal pair (csrc/causal_fwd.cu, causal_bwd.cu: the dense causal route at
Dh 64 and 128, a causal band of every block with no [CLS] slot) as K1
and K2. K4 at the mass-sampling batch [1000, 32768] and at the fused frontier's
[4096, 32768], the lockstep decode step (`decode_step_z`) bit for bit
the row-wise one at every row's position, and r5's chunk peek
(`decode_chunk_z`) against its sequential decode steps within the serve
tolerance. The MoE LM's step (real-prose-lm-moe at 2 layers) and the
latent tooling's compute (gather, knn_scores, reconstruct, the console)
as chip_smoke.py's moe-train and latent phases hold them.
"""
import pytest
import torch

from sparse_vae_tpu_torch.models.generation import SamplingParams, gumbel_noise
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.ops import (causal_kernel, ce_kernel,
                                      select_kernel, sp_kernel, swa_kernel)
from sparse_vae_tpu_torch.ops.attention import Attention
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    SlidingWindowAttentionPackedFn, sliding_window_attention,
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)
from sparse_vae_tpu_torch.server import ServeEngine

GRAD_REL = 1e-2
# K4 at [4096, 32768]: on an NVIDIA H100 80GB HBM3 at 700 W, 2,068 of the
# test's rows clear the 1e-4 margin and none differs; this floor keeps
# the share the floors of the [1000, 32768] test keep.
K4_FRONTIER_HELD = 1950


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
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_select_kernel_at_the_mass_sampling_batch(cuda, temperature):
    """K4 at [1000, 32768], the sample entry's batch (one CTA a row), as
    test_select_kernel_matches_plain holds it, with floors: on an NVIDIA
    H100 80GB HBM3 at 700 W, 478 of these rows clear the margin at T 1.0
    and 959 at T 0.7, and no row differs. So at least 450 and 900 rows
    must be held, and at most 10 rows (1%) may differ below the
    margin."""
    gen = torch.Generator(device=cuda).manual_seed(1000)
    s = 4.0 * torch.randn((1000, 32768), generator=gen, device=cuda)
    noise = gumbel_noise(s.shape, gen)
    kw = {"top_p": 0.9, "temperature": temperature}
    got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    assert torch.equal(got, select_kernel.nucleus_gumbel_argmax(s, noise,
                                                                **kw))
    want, _, margin = select_kernel.select_rows_plain(s, noise, **kw)
    held = margin > 1e-4
    assert torch.equal(got[held], want[held])
    assert int(held.sum()) >= {1.0: 450, 0.7: 900}[temperature]
    assert int((got != want).sum()) <= 10


@pytest.mark.gpu
def test_select_kernel_at_the_fused_frontier_rows(cuda):
    """K4 at [4096, 32768], the rows of 8 frontier windows of 512
    (models/parallel_decode.py with fused_select), as
    test_select_kernel_at_the_mass_sampling_batch holds it: bit for bit
    across two calls, the plain version's choice on every row whose
    bisection margin clears 1e-4, and at most 1% of the rows different
    below it. The floor on the held rows: K4_FRONTIER_HELD."""
    gen = torch.Generator(device=cuda).manual_seed(4096)
    s = 4.0 * torch.randn((4096, 32768), generator=gen, device=cuda)
    noise = gumbel_noise(s.shape, gen)
    kw = {"top_p": 0.9, "temperature": 1.0}
    got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    assert torch.equal(got, select_kernel.nucleus_gumbel_argmax(s, noise,
                                                                **kw))
    want, _, margin = select_kernel.select_rows_plain(s, noise, **kw)
    held = margin > 1e-4
    assert torch.equal(got[held], want[held])
    assert int(held.sum()) >= K4_FRONTIER_HELD
    assert int((got != want).sum()) <= 41


@pytest.mark.gpu
def test_decode_chunk_z_is_nine_decode_steps_on_r5(cuda):
    """r5 in its bf16 serving form: decode_chunk_z of 9 positions at 0 (z
    injected) and at 250 (across block 2's start, where the ring of two
    blocks wraps), each peek then committed, against 18 sequential
    decode_step_z calls on the same tokens and z, within the serve
    tolerance of chip_smoke.py's model phase: mean |logit difference|
    <= 0.25 and the same argmax at >= 90% of the positions."""
    from sparse_vae_tpu_torch.checkpoint import load_run
    model, hp, _ = load_run("real-prose-vae-r5", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    toks = torch.randint(3, hp.vocab_size, (1, 259), generator=gen,
                         device=cuda)
    z = torch.randn((1, 1, hp.latent_depth), generator=gen, device=cuda)
    chunked, steps = model.init_caches(1, 259), model.init_caches(1, 259)
    got, want = [], []
    with torch.inference_mode():
        for i in range(259):
            logits, steps = model.decode_step_z(toks[:, i], steps, i, z)
            if i < 9 or i >= 250:
                want.append(logits)
        for start in (0, 250):
            if start:
                for i in range(9, start):
                    model.decode_step_z(toks[:, i], chunked, i, z)
            logits, kvs = model.decode_chunk_z(toks[:, start:start + 9],
                                               chunked, start, z)
            model.commit_chunk(chunked, kvs, start, 9)
            got.append(logits[0])
    got, want = torch.cat(got), torch.cat(want)
    assert (got - want).abs().mean().item() <= 0.25
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree >= 0.9


@pytest.mark.gpu
def test_decode_step_z_is_the_rowwise_step_on_the_card(cuda):
    """A tiny bf16 Transformer-VAE with r5's head geometry (Dh 64, block
    128, window 2): decode_step_z at each index of 300 equals
    decode_step_z_rowwise with every row at that index, bit for bit,
    through the ring's wrap at 256."""
    torch.manual_seed(0)
    hp = TransformerVAEHparams(d_model=128, num_heads=2, num_layers=2,
                               latent_depth=8, vocab_size=512,
                               attn_window_size=2, attn_block_size=128)
    model = TransformerVAE(hp).to(cuda, torch.bfloat16).eval()
    b, ml = 4, 300
    gen = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((b, 1, 8), generator=gen, device=cuda)
    toks = torch.randint(3, 512, (ml, b), generator=gen, device=cuda)
    one, rows = model.init_caches(b, ml), model.init_caches(b, ml)
    with torch.inference_mode():
        for i in range(ml):
            got, one = model.decode_step_z(toks[i], one, i, z)
            want, rows = model.decode_step_z_rowwise(
                toks[i], rows, torch.full((b,), i, device=cuda), z)
            assert torch.equal(got, want), i


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
    with pytest.raises(ValueError):                            # D = 384
        ce_kernel.tied_ce_fwd(gb[:, :384].contiguous(),
                              table[:, :384].contiguous(), bias, labels)


@pytest.mark.gpu
@pytest.mark.parametrize("t,vocab,padded", [(1000, 32768, 100),
                                            (16383, 32768, 0),
                                            (3000, 2048, 37)])
def test_tied_ce_kernels_at_the_lm_width(cuda, t, vocab, padded):
    """K3 and K3b at D = 256 (the Transformer LM's instantiation) against
    their fp32 plain versions, token counts off the 128-token tile, with
    and without the vocab split and padding; both repeat bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(t + vocab)
    g = (0.5 * torch.randn((t, 256), generator=gen, device=cuda)).to(
        torch.bfloat16)
    table = (0.5 * torch.randn((vocab, 256), generator=gen, device=cuda)
             ).to(torch.bfloat16)
    bias = torch.randn(vocab, generator=gen, device=cuda)
    labels = torch.randint(0, vocab, (t,), generator=gen, device=cuda)
    dnll = torch.rand(t, generator=gen, device=cuda)
    labels[t - padded:] = 0
    dnll[t - padded:] = 0.0
    f0, b0 = ce_kernel.fwd_launches_d256, ce_kernel.bwd_launches_d256
    nll, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    nll2, lse2 = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    got = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    again = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    assert (ce_kernel.fwd_launches_d256,
            ce_kernel.bwd_launches_d256) == (f0 + 2, b0 + 2)
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want_nll, want_lse = ce_kernel.tied_ce_fwd_plain(g, table, bias, labels)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=0)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, want_lse, dnll)
    for name, a, b in zip(("dg", "dE", "dbias"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        _assert_rel(a, b, name)


@pytest.mark.gpu
@pytest.mark.parametrize("length", [512, 1536])
def test_dense_route_kernels_match_plain(cuda, length):
    """The dense causal pair on ragged rows against the band plain
    versions at a causal band of every block with no [CLS] slot (the
    function the dense causal route computes, and runs on the CPU),
    counted in the dense counters; the dense causal Attention takes the
    pair on the card and has a gradient."""
    gen = torch.Generator(device=cuda).manual_seed(length)
    q, k, v, do = (torch.randn((3, 2, length, 64), generator=gen,
                               device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    lens = torch.tensor([length, length - 200, 129], dtype=torch.int32,
                        device=cuda)
    mask = torch.arange(length, device=cuda)[None, :] < lens[:, None]
    kw = dict(window_size=length // 128, block_size=128, causal=True,
              include_cls=False)
    f0, b0 = swa_kernel.dense_launches, swa_kernel.dense_bwd_launches
    out, lse = causal_kernel.causal_fwd(q, k, v, lens)
    grads = causal_kernel.causal_bwd(q, k, v, lens, lse, out, do)
    assert (swa_kernel.dense_launches,
            swa_kernel.dense_bwd_launches) == (f0 + 1, b0 + 1)
    ref, ref_lse = sliding_window_attention_plain(q, k, v, mask,
                                                  return_lse=True, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    want = sliding_window_attention_bwd_plain(q, k, v, lens, lse, out, do,
                                              **kw)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _assert_rel(a, b, name)

    attn = Attention(128, 2, causal=True, sparse=False).to(cuda)
    x = torch.randn((2, length, 128), device=cuda, requires_grad=True)
    f0 = swa_kernel.dense_launches
    attn(x.to(torch.bfloat16), kv_mask=mask[:2]).float().sum().backward()
    assert swa_kernel.dense_launches == f0 + 1
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length,lengths", [
    (512, [512, 417, 1]),
    (1024, [1024, 1000, 129, 0]),
    (3584, [3584, 3101, 1537]),
])
def test_dense_causal_pair_matches_plain(cuda, d, length, lengths):
    """The dense causal pair against its plain versions on full and ragged
    rows (a length that is no multiple of 128, a length of 1, a row with
    no valid key), bit for bit in two calls, counted in the dense counters
    and in no band counter; beside PERF.md's gates, each row of out, dq,
    dk and dv past `causal_kernel.row_start` within ROW_REL_TOL of the
    plain version's norm."""
    gen = torch.Generator(device=cuda).manual_seed(length + d)
    q, k, v, do = (_randn(gen, len(lengths), 2, length, d) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = {name: getattr(swa_kernel, name) for name in (
        "dense_launches", "dense_bwd_launches", "launches", "bwd_launches",
        "hm128_launches", "hm128_bwd_launches", "generic_launches",
        "generic_bwd_launches")}

    def run():
        out, lse = causal_kernel.causal_fwd(q, k, v, lens)
        return out, lse, causal_kernel.causal_bwd(q, k, v, lens, lse, out,
                                                  do)

    got, again = run(), run()
    moved = {name: getattr(swa_kernel, name) - n
             for name, n in before.items()}
    assert moved == {**{name: 0 for name in before}, "dense_launches": 2,
                     "dense_bwd_launches": 2}
    q32, k32, v32 = q.float(), k.float(), v.float()
    ref, ref_lse = causal_kernel.causal_attention_plain(q32, k32, v32, lens)
    want = causal_kernel.causal_attention_bwd_plain(
        q32, k32, v32, lens, got[1], got[0].float(), do.float())
    _held(got, again, ref, ref_lse, want)
    rows = [causal_kernel.row_rel_err(x, w)
            for x, w in zip((got[0], *got[2]), (ref, *want))]
    assert max(rows) <= causal_kernel.ROW_REL_TOL, rows
    if 0 in lengths:
        row = lengths.index(0)
        assert bool((got[0][row] == 0).all())
        assert all(bool((g[row] == 0).all()) for g in got[2])


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
        swa_kernel.swa_fwd_packed(qb, qb, qb, lengths, 64)      # Dh 4


@pytest.mark.gpu
def test_plain_routes_raise_on_the_card(cuda):
    """A sparse attention and a dense causal one at Dh = 520 and a tied
    loss at D = 384 lie inside the JAX package's kernel gates but beyond
    every CUDA kernel: on the card they raise instead of running the plain
    version."""
    narrow = Attention(1040, 2, causal=True, sparse=True).to(cuda)
    with pytest.raises(NotImplementedError, match="head_dim 520"):
        narrow(torch.zeros((1, 128, 1040), device=cuda))
    wide = Attention(1040, 2, causal=True, sparse=False).to(cuda)
    with pytest.raises(NotImplementedError, match="head_dim 520"):
        wide(torch.zeros((1, 512, 1040), device=cuda))
    hp = TransformerVAEHparams(d_model=384, num_heads=2, num_layers=1,
                               latent_depth=16, vocab_size=1024,
                               num_encoder_latents=8)
    model = TransformerVAE(hp).to(cuda)
    with pytest.raises(NotImplementedError, match="d_model 384"):
        model.sequence_nll(torch.zeros((1, 256, 384), device=cuda),
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


@pytest.mark.gpu
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_cudnn_rnn_matches_the_step_loop(cuda, rnn_type):
    """The fused RNN (cuDNN, fp32 math) against the step loop on the card:
    a 2-layer stack at H 256 over [3, 300] from given states, outputs and
    final states within 1e-4 of the largest entry, every gradient within
    1e-3; for the LSTM also the masked bidirectional encoder over ragged
    rows and an empty row. The step loop's CUDA counter moves only for
    the step loop's own calls."""
    from sparse_vae_tpu_torch.ops import rnn

    gen = torch.Generator().manual_seed(3)
    stack = rnn.StackedRNN(96, 256, 2, rnn_type)
    for p in stack.parameters():
        p.data.normal_(0.0, 0.0625, generator=gen)
    stack = stack.to(cuda)
    x = torch.randn((3, 300, 96), generator=gen).to(cuda)
    init = [torch.randn((3, 256), generator=gen).to(cuda) for _ in range(2)]
    states = ([(torch.tanh(c), c) for c in init] if rnn_type == "LSTM"
              else [torch.tanh(c) for c in init])

    def run(step_loop):
        stack.zero_grad(set_to_none=True)
        out, finals = rnn.use_step_loop(stack, step_loop)(x, states)
        h = torch.stack([f[0] if rnn_type == "LSTM" else f for f in finals])
        (out.square().mean() + h.sum()).backward()
        return out.detach(), h.detach(), {n: p.grad.clone() for n, p in
                                          stack.named_parameters()}

    before = rnn.step_loop_cuda_calls
    fused = run(False)
    assert rnn.step_loop_cuda_calls == before
    loop = run(True)
    assert rnn.step_loop_cuda_calls == before + 2
    for got, want, name in zip(fused[:2], loop[:2], ("out", "h_n")):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (name, err)
    for name, want in loop[2].items():
        err = (fused[2][name] - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), (name, err)
    assert not torch.backends.cudnn.allow_tf32
    if rnn_type != "LSTM":
        return
    enc = rnn.BiLSTMEncoder(96, 64, 2).to(cuda)
    for p in enc.parameters():
        p.data.normal_(0.0, 0.0625)
    lengths = torch.tensor([300, 120, 0], device=cuda)
    mask = torch.arange(300, device=cuda)[None, :] < lengths[:, None]
    c0 = torch.randn((2, 64), device=cuda)
    with torch.no_grad():
        got = enc(x, mask, c0)
        want = rnn.use_step_loop(enc)(x, mask, c0)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.allclose(got[2], torch.tanh(c0).reshape(-1))


@pytest.mark.gpu
def test_moe_step_through_the_kernels_matches_plain(cuda):
    """chip_smoke.py's moe-train phase at 2 of real-prose-lm-moe's layers
    (full width, 8 experts, top-2) on one group of 2 micro-batches of
    [8, 1024] ragged documents: 2 steps through the dense causal pair
    and K3/K3b, step 1 against the fp32 plain step (loss within
    0.1%, gradients at cosine >= 0.99 or the near-zero rule), the route
    flips counted; every check raises inside the phase."""
    import chip_smoke
    stats = chip_smoke.moe_train_phase("pytest", depth=2, group=(8, 1024),
                                       steps=2)
    assert stats["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert stats["launches"]["swa_fwd_dense"] == 2 * 2 * 2
    assert stats["gradients"] == 6 + 16 * 2
    assert len(stats["route_flips_vs_fp32_plain"]) == 2


@pytest.mark.gpu
def test_gather_and_reconstruct_on_the_card(cuda):
    """chip_smoke.py's latent phase on 16 documents with a reconstruction
    of 64 positions: gather in bf16 against the fp32 plain model,
    knn_scores against knn.py's float64 formulas, K4 once a
    reconstruction step with every choice held against the plain
    selection, a scripted console session."""
    import chip_smoke
    stats = chip_smoke.latent_phase("pytest", n_docs=16, max_length=64)
    assert max(stats["gather_rel_err_vs_fp32_plain"].values()) <= (
        chip_smoke.LATENT_REL_TOL)
    assert stats["launches"]["nucleus_select"] == (
        stats["reconstruct"]["steps"]) > 0


# -- the generic pair (csrc/swa_generic.cu) and head-major Dh 128 ----------
def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _held(got, again, want_out, want_lse, want_grads, names="qkv"):
    """out and lse as K1's, gradients as K2's, bit for bit in two calls."""
    out, lse, grads = got
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for a, b in zip(grads, again[2]):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2,
                               rtol=2e-2)
    finite = torch.isfinite(want_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-3,
                               rtol=1e-5)
    for name, g, w in zip(names, grads, want_grads):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        if w.abs().max() > 0:
            _assert_rel(g, w, "d" + name)
        else:
            assert bool((g == 0).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("d,block,window,causal,include_cls,q_off", [
    (32, 256, 2, True, True, 0),      # bench.py --heads 16, block 256
    (32, 128, 2, True, True, 0),
    (64, 256, 2, False, True, 0),     # block 256, bidirectional
    (64, 256, 3, True, False, 1),     # q_off in blocks of 256
    (8, 128, 1, True, True, 0),       # the narrowest head
    (80, 128, 2, False, False, 0),    # Dh padded to a multiple of 16
    (384, 128, 2, True, True, 0),     # two output chunks, the last partial
    (512, 256, 2, True, True, 0),
    (24, 128, 2, True, True, 0),      # Dh no multiple of 16, one half
    (40, 384, 2, False, True, 0),     # ... at block 384, bidirectional
    (256, 384, 3, True, True, 0),     # the widest Hopper head, block 384
    (512, 128, 2, False, True, 0),    # Dh 512: two chunks, bidirectional
    (192, 256, 2, True, False, 2),    # three halves, q_off
])
def test_generic_head_major_matches_plain(cuda, d, block, window, causal,
                                          include_cls, q_off):
    """The generic pair on head-major operands at shapes no tuned
    instantiation takes, ragged rows and an empty one, against the plain
    versions, launched through the generic entry, bit for bit in two
    calls."""
    gen = torch.Generator(device=cuda).manual_seed(d + block + window)
    L = 4 * block
    key_len = L + q_off * block
    q, do = _randn(gen, 3, 2, L, d), _randn(gen, 3, 2, L, d)
    k, v = _randn(gen, 3, 2, key_len, d), _randn(gen, 3, 2, key_len, d)
    lengths = torch.tensor([key_len, key_len - block - 37, 0],
                           dtype=torch.int32, device=cuda)
    kw = dict(window_size=window, block_size=block, causal=causal,
              include_cls=include_cls, q_off=q_off)
    f0, b0 = swa_kernel.generic_launches, swa_kernel.generic_bwd_launches

    def run():
        out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
        return out, lse, swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                                            **kw)

    got, again = run(), run()
    assert (swa_kernel.generic_launches,
            swa_kernel.generic_bwd_launches) == (f0 + 2, b0 + 2)
    mask = torch.arange(key_len, device=cuda)[None, :] < lengths[:, None]
    ref, ref_lse = sliding_window_attention_plain(q, k, v, mask,
                                                  return_lse=True, **kw)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, got[1],
                                              got[0], do, **kw)
    _held(got, again, ref, ref_lse, want)
    assert bool((got[0][2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d,heads,block,causal", [
    (256, 2, 128, True),      # bench.py --heads 2: the slice's shape
    (256, 2, 128, False),
    (128, 4, 256, True),      # K5's head dim at block 256
    (512, 1, 128, True),      # the widest head: d_model 512, one head
    (256, 2, 384, True),      # Dh 256 at block 384
    (384, 1, 256, False),     # a chunked head at block 256
])
def test_generic_packed_matches_plain(cuda, d, heads, block, causal):
    """The generic pair on packed [B, L, H * Dh] operands through the
    packed autograd Function, against the packed plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(d + heads + block)
    L = 4 * block
    q, k, v, do = (_randn(gen, 3, L, heads * d) for _ in range(4))
    lengths = torch.tensor([L, L - 300, 1], dtype=torch.int32, device=cuda)
    kw = dict(window_size=2, block_size=block, causal=causal,
              include_cls=True)

    def run():
        out, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads, **kw)
        return out, lse, swa_kernel.swa_bwd_packed(q, k, v, lengths, lse,
                                                   out, do, heads, **kw)

    f0 = swa_kernel.generic_launches
    got, again = run(), run()
    assert swa_kernel.generic_launches == f0 + 2
    ref, ref_lse = sliding_window_attention_packed_plain(
        q.float(), k.float(), v.float(), lengths, heads, **kw)
    want = sliding_window_attention_packed_bwd_plain(
        q.float(), k.float(), v.float(), lengths, got[1], got[0].float(),
        do.float(), heads, **kw)
    _held(got, again, ref, ref_lse, want)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = SlidingWindowAttentionPackedFn.apply(*leaves, lengths, heads, 2,
                                               block, causal, True)
    out.backward(do)
    for t, g in zip(leaves, got[2]):
        assert torch.equal(t.grad, g)


@pytest.mark.gpu
@pytest.mark.parametrize("d,block,start", [(256, 128, 1024), (256, 128, 0),
                                           (128, 128, 1024), (32, 256, 1024),
                                           (256, 256, 1024), (40, 128, 512)])
def test_sp_kernel_beyond_dh_64_matches_plain(cuda, d, block, start):
    """K6 at Dh 256 and block 256 (the generic pair with q_off and the
    broadcast [CLS] block) and at Dh 128 (K1/K2's head-major Dh 128
    instantiation), both branches, ragged rows, a partial [CLS] and a
    filler row, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d + block + start)
    S, ctx = 4 * block, block
    q, do = _randn(gen, 3, 2, S, d), _randn(gen, 3, 2, S, d)
    k_ext, v_ext = _randn(gen, 3, 2, ctx + S, d), _randn(gen, 3, 2, ctx + S, d)
    cls_k, cls_v = _randn(gen, 3, 2, block, d), _randn(gen, 3, 2, block, d)
    full = S if start == 0 else ctx + S
    ext_len = torch.tensor([full, full // 2, 0], dtype=torch.int32,
                           device=cuda)
    cls_len = torch.tensor([block, 77, 0], dtype=torch.int32, device=cuda)
    args = (q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len)
    counter = "hm128" if d == 128 and block == 128 else "generic"
    f0 = getattr(swa_kernel, f"{counter}_launches")

    def run():
        out, lse = sp_kernel.sp_fwd(*args, 2, block)
        return out, lse, sp_kernel.sp_bwd(*args, out, lse, do, 2, block)

    got, again = run(), run()
    assert getattr(swa_kernel, f"{counter}_launches") == f0 + 2
    ref, ref_lse = sp_kernel.sp_fwd_plain(*args, 2, block)
    want = sp_kernel.sp_bwd_plain(*args, got[0], got[1], do, 2, block)
    _held(got, again, ref, ref_lse, want,
          names=("q", "k_ext", "v_ext", "cls_k", "cls_v"))


@pytest.mark.gpu
@pytest.mark.parametrize("d,heads,packed,block,window,causal", [
    (256, 2, True, 128, 2, True),     # bench.py --heads 2's layout
    (32, 4, False, 128, 2, True),     # --heads 16's head dim
    (24, 2, False, 256, 3, False),    # bidirectional: left 2
    (40, 2, True, 128, 1, True),
])
def test_generic_cls_column_in_chunks_matches_plain(cuda, d, heads, packed,
                                                    block, window, causal):
    """Key block 0's [CLS] column split into three or more chunks of
    query blocks (fp32 partials summed in a fixed order by the reduce),
    on rows whose length ends inside a chunk, inside the band part and at
    a block edge, against the plain versions; bit for bit in two calls."""
    gen = torch.Generator(device=cuda).manual_seed(d + block + window)
    left = window if causal else (window + 1) // 2
    blocks = left + 2 * swa_kernel.CLS_CHUNK + 3   # three chunks
    L = blocks * block
    assert swa_kernel.cls_chunks(blocks, window, causal, True) == 3
    lengths = torch.tensor(
        [L, (left + swa_kernel.CLS_CHUNK + 3) * block + 50,
         block // 2 + 8, (left + 1) * block], dtype=torch.int32,
        device=cuda)
    shape = (4, L, heads * d) if packed else (4, heads, L, d)
    q, k, v, do = (_randn(gen, *shape) for _ in range(4))
    kw = dict(window_size=window, block_size=block, causal=causal,
              include_cls=True)

    def run():
        if packed:
            out, lse = swa_kernel.swa_fwd_packed(q, k, v, lengths, heads,
                                                 **kw)
            return out, lse, swa_kernel.swa_bwd_packed(
                q, k, v, lengths, lse, out, do, heads, **kw)
        out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
        return out, lse, swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                                            **kw)

    f0 = swa_kernel.generic_bwd_launches
    got, again = run(), run()
    assert swa_kernel.generic_bwd_launches == f0 + 2
    if packed:
        ref, ref_lse = sliding_window_attention_packed_plain(
            q.float(), k.float(), v.float(), lengths, heads, **kw)
        want = sliding_window_attention_packed_bwd_plain(
            q.float(), k.float(), v.float(), lengths, got[1],
            got[0].float(), do.float(), heads, **kw)
    else:
        mask = torch.arange(L, device=cuda)[None, :] < lengths[:, None]
        ref, ref_lse = sliding_window_attention_plain(
            q, k, v, mask, return_lse=True, **kw)
        want = sliding_window_attention_bwd_plain(q, k, v, lengths, got[1],
                                                  got[0], do, **kw)
    _held(got, again, ref, ref_lse, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,blocks", [(32, 7), (256, 5), (40, 9)])
def test_generic_dense_route_with_an_odd_block_count(cuda, d, blocks):
    """The generic pair on the dense causal route (a causal band of every
    block, no [CLS] slot) at an odd number of blocks, the grids running
    the longest rows and columns first, on ragged rows against the plain
    versions; bit for bit in two calls."""
    gen = torch.Generator(device=cuda).manual_seed(d + blocks)
    L = blocks * 128
    q, k, v, do = (_randn(gen, 3, 2, L, d) for _ in range(4))
    lengths = torch.tensor([L, L - 200, 129], dtype=torch.int32,
                           device=cuda)
    kw = dict(window_size=blocks, block_size=128, causal=True,
              include_cls=False)

    def run():
        out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
        return out, lse, swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                                            **kw)

    f0 = swa_kernel.generic_launches
    got, again = run(), run()
    assert swa_kernel.generic_launches == f0 + 2
    mask = torch.arange(L, device=cuda)[None, :] < lengths[:, None]
    ref, ref_lse = sliding_window_attention_plain(q, k, v, mask,
                                                  return_lse=True, **kw)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, got[1],
                                              got[0], do, **kw)
    _held(got, again, ref, ref_lse, want)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("include_cls", [True, False])
def test_swa_kernels_at_head_major_dh_128_match_plain(cuda, causal,
                                                      include_cls):
    """K1/K2's head-major Dh 128 instantiation (tensor parallelism's
    heads of bench.py --heads 4) on ragged rows against the plain
    versions, counted in the hm128 counters, bit for bit in two calls."""
    gen = torch.Generator(device=cuda).manual_seed(128 + causal)
    q, k, v, do = (_randn(gen, 3, 4, 1024, 128) for _ in range(4))
    lengths = torch.tensor([1024, 700, 129], dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, include_cls=include_cls)
    f0, b0 = swa_kernel.hm128_launches, swa_kernel.hm128_bwd_launches

    def run():
        out, lse = swa_kernel.swa_fwd(q, k, v, lengths, **kw)
        return out, lse, swa_kernel.swa_bwd(q, k, v, lengths, lse, out, do,
                                            **kw)

    got, again = run(), run()
    assert (swa_kernel.hm128_launches,
            swa_kernel.hm128_bwd_launches) == (f0 + 2, b0 + 2)
    mask = torch.arange(1024, device=cuda)[None, :] < lengths[:, None]
    ref, ref_lse = sliding_window_attention_plain(q, k, v, mask,
                                                  return_lse=True, **kw)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, got[1],
                                              got[0], do, **kw)
    _held(got, again, ref, ref_lse, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,heads,tp,counter", [
    (512, 4, 2, "hm128"),     # bench.py --heads 4 over model 2: K1/K2 Dh 128
    (512, 2, 1, "generic"),   # bench.py --heads 2: the generic pair, packed
    (512, 16, 1, "generic"),  # bench.py --heads 16: Dh 32, head-major
])
def test_attention_layers_take_the_new_kernels(cuda, d_model, heads, tp,
                                               counter):
    """Sparse causal attention layers whose shapes raised before run a
    kernel forward and backward on the card, with a finite gradient, and
    the dense causal route at Dh 128 (the dense causal pair) and 256 (the
    generic pair) likewise."""
    torch.manual_seed(0)
    attn = Attention(d_model, heads, causal=True, sparse=True,
                     tp_size=tp).to(cuda, torch.bfloat16)
    x = torch.randn((2, 512, d_model), device=cuda, requires_grad=True)
    mask = torch.arange(512, device=cuda)[None, :] < torch.tensor(
        [[512], [300]], device=cuda)
    f0 = getattr(swa_kernel, f"{counter}_launches")
    b0 = getattr(swa_kernel, f"{counter}_bwd_launches")
    attn(x.to(torch.bfloat16), kv_mask=mask).float().sum().backward()
    assert getattr(swa_kernel, f"{counter}_launches") == f0 + 1
    assert getattr(swa_kernel, f"{counter}_bwd_launches") == b0 + 1
    assert bool(torch.isfinite(x.grad).all())
    for d_dense, counter in ((256, "dense"), (512, "generic")):
        dense = Attention(d_dense, 2, causal=True, sparse=False).to(
            cuda, torch.bfloat16)
        f0 = getattr(swa_kernel, f"{counter}_launches")
        with torch.no_grad():
            y = dense(torch.randn((1, 512, d_dense), device=cuda,
                                  dtype=torch.bfloat16))
        assert getattr(swa_kernel, f"{counter}_launches") == f0 + 1
        assert bool(torch.isfinite(y.float()).all())

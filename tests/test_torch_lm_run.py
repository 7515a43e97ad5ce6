"""The Transformer LM family's entry points on the CPU: the
continuous-batching engine and its greedy slice against the JAX package,
the training CLI and the `test` entry on a tiny LM (each test batch's NLL
against the JAX package's ARObjective.eval_stats on the same weights,
2e-5 relative), the step form of `train` on draft-tlm-r5, the archive
round trip, the presets, and real-prose-lm-r4's geometry from the JAX
initialisation.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu import build_model
from sparse_vae_tpu.models.generation import (
    SamplingParams as JSamplingParams, init_row_decode_state as j_init_state)
from sparse_vae_tpu.serving import _get_slice_fn
from sparse_vae_tpu.utils import config as jconfig
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import cli as tcli
from sparse_vae_tpu_torch import load_checkpoint_for_name, train
from sparse_vae_tpu_torch.models.generation import (SamplingParams,
                                                    init_row_decode_state)
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.server import ServeEngine
from sparse_vae_tpu_torch.serving import make_slice_fn, rowwise_family
from sparse_vae_tpu_torch.utils import config as tconfig
from tests.test_torch_eval_train import _jax_params_of
from tests.test_torch_lm import LOSS_RTOL, RUN, _archive, _jax_lm
from tests.test_torch_checkpoint import jax_params_from_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = SamplingParams(top_k=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small models: one intra-op thread runs them as fast and leaves the
    suite's other workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_lm(seed=0, sparse=False):
    torch.manual_seed(seed)
    hp = TransformerHparams(d_model=128, num_heads=2, num_layers=2,
                            vocab_size=1024, sparse_self_attention=sparse)
    return TransformerLanguageModel(hp).eval().requires_grad_(False)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 1024, n)]


# -- serving ----------------------------------------------------------------
def test_greedy_rowwise_decode_matches_jax_on_draft():
    """Two rows, 24 greedy steps (repetition penalty 1.2) of draft-tlm-r5
    in fp32 through the row-wise slice, no z: token for token the
    reference's."""
    module, _ = _jax_lm()
    params = jax_params_from_archive(_archive())
    model, _, _ = ckpt.load_run(RUN, device="cpu", dtype=torch.float32)
    assert rowwise_family(model) is False
    b, ml, steps = 2, 64, 24
    j_slice = _get_slice_fn(module, False, JSamplingParams(top_k=1), 2,
                            steps, False, False)
    j_state = j_init_state(b, ml, 1, jax.random.PRNGKey(0))
    j_state, _ = j_slice(params, j_state,
                         module.apply({"params": params}, b, ml,
                                      method=type(module).init_caches),
                         None)
    t_slice = make_slice_fn(model, GREEDY, 2, steps, False)
    t_state = init_row_decode_state(b, ml, 1, torch.Generator())
    t_state, _ = t_slice(t_state, model.init_caches(b, ml), None)
    np.testing.assert_array_equal(t_state.tokens.numpy(),
                                  np.asarray(j_state.tokens))
    assert int(t_state.index.max()) > 10


def test_engine_serves_the_lm_through_rows_and_refills():
    """7 requests (with and without prompts, some bulk-prefilled) through
    a 3-row batch of a dense LM: all complete, each seed's output is the
    same whichever row served it, no z is drawn."""
    engine = ServeEngine(_tiny_lm(), batch_size=3, max_length=64,
                         sampling=GREEDY, slice_steps=4, end_token=-1)
    try:
        prompts = [None, _prompt(5, 1), _prompt(20, 2)]
        futures = [engine.submit(max_tokens=6 + (i % 3), seed=100 + (i % 3),
                                 prompt_tokens=prompts[i % 3])
                   for i in range(7)]
        outs = [f.result(120) for f in futures]
        for i in range(7):
            np.testing.assert_array_equal(outs[i], outs[i % 3])
            p = len(prompts[i % 3] or ())
            assert len(outs[i]) == p + 6 + (i % 3)
        stats = engine.snapshot()
        # The 21-position prompts only: 6 positions stay under the
        # bulk_prefill_min of 16.
        assert stats["served"] == 7 and stats["prefills"] == 2
        assert engine.is_vae is False and engine._latent == 0
    finally:
        engine.shutdown(timeout=30)


@pytest.mark.parametrize("sparse,prompt_len", [(False, 450), (True, 300)])
def test_lm_bulk_prefill_equals_forced_prefill(sparse, prompt_len):
    """One teacher-forced forward (fill_cache_row) gives the same greedy
    continuation as forcing the prompt token by token: a dense LM whose
    prompt pads to 512 positions (the dense causal route, K1's plain
    version here) and a sparse one over its block ring."""
    prompt = _prompt(prompt_len, prompt_len)
    outs = []
    for bulk_min in (16, 10_000):
        engine = ServeEngine(_tiny_lm(sparse=sparse), batch_size=2,
                             max_length=600, sampling=GREEDY,
                             slice_steps=256, end_token=-1,
                             bulk_prefill_min=bulk_min)
        try:
            outs.append(engine.generate(8, seed=3, prompt_tokens=prompt,
                                        timeout=300))
            assert engine.snapshot()["prefills"] == (bulk_min == 16)
        finally:
            engine.shutdown()
    np.testing.assert_array_equal(outs[0], outs[1])


# -- training and evaluation entry points -------------------------------------
TINY = ["data.dataset_name=synthetic", "data.synthetic_docs=200",
        "data.tokens_per_batch=4096", "data.max_tokens_per_sample=512",
        "data.vocab_size=1024", "model.d_model=128", "model.num_heads=2",
        "model.num_layers=2", "model.vocab_size=1024",
        "model.sparse_self_attention=false", "model.loss_chunk_size=256",
        "trainer.log_every_n_steps=1", "trainer.checkpoint_every_n_steps=2",
        "trainer.val_check_interval=0.1", "device=cpu"]


def test_lm_train_cli_and_test_entry_match_jax(tmp_path, monkeypatch,
                                               capsys):
    """`python -m sparse_vae_tpu_torch.train transformer-lm <dotlist>` on
    the CPU: 3 steps with validation (val_nll, val_bpb, val_loss) and
    checkpoints, then `python -m sparse_vae_tpu_torch.test transformer-lm
    <run>` on the newest one: its lines are JAX test.py's, and each
    batch's NLL is the JAX package's eval_stats on the same weights."""
    from sparse_vae_tpu_torch import test as entry
    from sparse_vae_tpu_torch.data.text_data_module import (
        TextDataModuleHparams)
    monkeypatch.chdir(tmp_path)
    assert train.main(["train", "transformer-lm", *TINY,
                       "trainer.max_steps=3", "name=lm"]) == 0
    out = capsys.readouterr().out
    assert "Done: step=3 stopped=max_steps" in out
    run = tmp_path / "sparse-vae-logs" / "transformer-lm" / "lm"
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    names = {name for r in records for name in r} - {"t", "step"}
    assert {r["step"] for r in records if "val_nll" in r} == {1, 2, 3}
    assert {"val_bpb", "val_loss", "train_nll", "loss"} <= names
    assert not any(name.endswith("_kl") for name in names)
    assert sorted(p.name for p in (run / "checkpoints").glob("step_*")) \
        == ["step_1", "step_2", "step_3"]

    average = entry.main(["test", "transformer-lm", "lm", "device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"Average test loss: {average}"
    model, hp, objective, _, meta = load_checkpoint_for_name(
        "transformer-lm", "lm", device="cpu")
    assert type(model) is TransformerLanguageModel
    cfg = tcli.assemble_config("transformer-lm", [])
    cfg.data = TextDataModuleHparams(**meta["data_hparams"])
    data = tcli.build_data(cfg)
    module, _, jobjective = build_model("transformer-lm",
                                        meta["model_hparams"])
    params = _jax_params_of(model)
    want_lines, losses = [], []
    for i, batch in enumerate(data.epoch_batches("test", seed=0)):
        if not (np.asarray(batch.num_tokens) > 0).any():
            continue
        arrays = {k: torch.from_numpy(np.asarray(v)).long()
                  for k, v in batch._asdict().items()}
        with torch.no_grad():
            nll = entry.lm_batch_nll(model, objective, arrays)
        losses.append(nll)
        want_lines.append(f"batch {i}: last={nll:.4f} "
                          f"avg={sum(losses) / len(losses):.4f}")
        stats = jobjective.eval_stats(
            module, params, {k: jnp.asarray(v) for k, v in
                             batch._asdict().items()},
            jax.random.PRNGKey(i))
        jax_nll = float(stats["nll_sum"]) / max(float(
            stats["token_count"]), 1.0)
        np.testing.assert_allclose(nll, jax_nll, rtol=LOSS_RTOL)
    assert lines[:-1] == want_lines and len(want_lines) >= 1
    assert 0 < average < 20


def test_batch_arrays_are_the_jax_packages():
    """training/objectives.py's batch_arrays: a TextBatch's token ids,
    token counts and byte counts as int64 tensors on the device asked
    for, the values of the JAX package's batch_arrays."""
    from sparse_vae_tpu.training.objectives import batch_arrays as j_arrays
    from sparse_vae_tpu_torch.data.batching import TextBatch
    from sparse_vae_tpu_torch.training.objectives import batch_arrays
    rng = np.random.default_rng(0)
    batch = TextBatch(
        token_ids=rng.integers(0, 1024, (3, 512)).astype(np.int32),
        num_tokens=np.array([512, 300, 0], np.int32),
        num_bytes=np.array([2048, 1200, 0], np.int32))
    got, want = batch_arrays(batch, "cpu"), j_arrays(batch)
    assert set(got) == set(want)
    for name, tensor in got.items():
        assert tensor.dtype == torch.int64 and tensor.device.type == "cpu"
        np.testing.assert_array_equal(tensor.numpy(), np.asarray(want[name]))


def test_train_step_form_on_the_draft_run(capsys):
    """`train transformer-lm draft-tlm-r5 steps=1 ...` takes one step of
    the archived LM's training form with ARObjective; a run of another
    experiment and, over a seq group, the run's dense attention are
    refused (JAX's ValueError, before any rank starts)."""
    assert train.main(["train", "transformer-lm", RUN, "steps=1", "batch=1",
                       "seq=512", "accumulate=1", "device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["loss"]) and line["train_nll"] == line["loss"]
    assert 5 < line["loss"] < 12 and line["tokens"] == 512
    with pytest.raises(SystemExit, match="transformer-lm"):
        train.main(["train", "transformer-vae", RUN, "device=cpu"])
    with pytest.raises(ValueError, match="sparse sliding-window decoder"):
        train.main(["train", "transformer-lm", RUN, "sp=2", "device=cpu"])


def test_draft_archive_round_trip(tmp_path):
    """export_archive of draft-tlm-r5 writes the archive's 36 leaves with
    their values bit for bit (they are bf16 already), and load_run reads
    it back as the same model."""
    model, _, meta = ckpt.load_run(RUN, device="cpu", dtype=torch.float32)
    out = ckpt.export_archive(model, meta, tmp_path / "draft", step=7)
    with np.load(out / "ckpt_bf16.npz") as npz:
        got = {k: npz[k] for k in npz.files}
    want = _archive()
    assert set(got) == set(want) and len(got) == 36
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    again, hp, _ = ckpt.load_run(str(out), device="cpu", dtype=torch.float32)
    assert type(again) is TransformerLanguageModel
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    served = ckpt.serving_form(model)
    assert served.dtype == torch.bfloat16 and not served.training


# -- configurations ----------------------------------------------------------
@pytest.mark.parametrize("experiment,preset", [
    ("transformer-lm", "nonvae-wikipedia"), ("transformer-lm", "nonvae-pg19"),
    ("transformer-lm", None), ("transformer-vae", "dense-benchmark")])
def test_lm_presets_build_the_same_hparams(experiment, preset):
    """build_hparams gives the JAX package's hparams field for field and
    its objective: ARObjective for the Transformer LM; the dense-benchmark
    preset builds a Transformer-VAE with dense attention."""
    from sparse_vae_tpu_torch.models.vae import VAEObjective
    from sparse_vae_tpu_torch.training.objectives import ARObjective
    dotlist = [f"preset={preset}"] if preset else []
    cfg = tcli.assemble_config(experiment, dotlist)
    overrides = {**cfg.model_overrides, "vocab_size": cfg.data.vocab_size}
    hp, objective = tcli.build_hparams(experiment, overrides)
    _, jhp, _ = build_model(experiment, overrides)
    assert tconfig.to_dict(hp) == jconfig.to_dict(jhp)
    is_lm = experiment == "transformer-lm"
    assert isinstance(objective, ARObjective if is_lm else VAEObjective)
    assert type(hp) is (TransformerHparams if is_lm else type(hp))
    if preset in ("nonvae-wikipedia", "dense-benchmark"):
        assert not hp.sparse_self_attention


def test_r4_geometry_from_the_jax_initialisation():
    """real-prose-lm-r4 (meta only: d_model 512, 8 heads, 6 dense layers)
    builds from its meta.json with the JAX initialisation: the same
    parameter count and shapes as the JAX package's model, the
    initialiser's scales (N(0, 0.02) weights, zero biases, unit
    LayerNorms, zero output bias)."""
    with open(os.path.join(REPO, "runs", "real-prose-lm-r4",
                           "meta.json")) as fh:
        meta = json.load(fh)
    hp = ckpt.hparams_from_meta(meta)
    assert type(hp) is TransformerHparams
    assert (hp.d_model, hp.num_heads, hp.num_layers) == (512, 8, 6)
    assert hp.grad_checkpointing and not hp.sparse_self_attention
    assert hp == train.run_hparams("real-prose-lm-r4")
    model, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(0),
                                       device="cpu", dtype=torch.float32)
    module, _, _ = build_model("transformer-lm", meta["model_hparams"])
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 128), jnp.int32))["params"]
    want = {"/".join(k): tuple(v.shape) for k, v in
            __import__("flax").traverse_util.flatten_dict(
                dict(shapes)).items()}
    got = {}
    for key, p in model.state_dict().items():
        path, transpose = ckpt.flax_path(model, key)
        got[path] = tuple(p.T.shape if transpose else p.shape)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 35_984_896
    named = dict(model.named_parameters())
    assert named["input_embedding.weight"].std().item() == pytest.approx(
        0.02, rel=0.02)
    assert named["decoder_layers.0.ffn_in.weight"].std().item() == \
        pytest.approx(0.02, rel=0.02)
    assert torch.equal(named["output_bias"], torch.zeros(32768))
    assert torch.equal(named["head_norm.weight"], torch.ones(512))

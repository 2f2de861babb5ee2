"""Port parity: the dynamic-``t`` decode steps (T5, PAWA, NCI), KV-cached
``generate``, ``trie_beam_search`` and ``brute_force_topk`` of
``mevi_tpu_torch`` against ``mevi_tpu`` on the same weights, float32 on
the CPU, and greedy ``generate`` against HF ``T5ForConditionalGeneration``.

Tolerances: hidden states, logits and scores 2e-5 (the JAX package's
f32 parity tolerance, tests/test_t5_parity.py); tokens, codes and
lengths equal.  Sampling cannot match JAX's stream (a torch generator):
it is held to its own contract (seeded, inside the filtered support,
greedy at top_k 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.decode import brute as jbrute
from mevi_tpu.decode import generate as jgen
from mevi_tpu.decode import trie as jtrie
from mevi_tpu.models import nci as jnci
from mevi_tpu.models import t5 as jt5
from mevi_tpu_torch.decode import brute as tbrute
from mevi_tpu_torch.decode import generate as tgen
from mevi_tpu_torch.decode import trie as ttrie
from mevi_tpu_torch.models import nci as tnci
from mevi_tpu_torch.models import t5 as tt5
from mevi_tpu_torch.weights import load_flax_params

transformers = pytest.importorskip("transformers")

ATOL = 2e-5
T5KW = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_heads=4,
            num_layers=2, num_decoder_layers=2)


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# T5 generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t5_pair():
    """HF T5ForConditionalGeneration, the JAX T5Model and the port's, one
    set of weights (HF's, through each package's converter)."""
    from mevi_tpu.models import convert as jconvert
    from mevi_tpu_torch.models import convert as tconvert
    cfg = transformers.T5Config(
        dropout_rate=0.0, feed_forward_proj="relu",
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0,
        tie_word_embeddings=True, **T5KW)
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(cfg).eval()
    nl, nd = T5KW["num_layers"], T5KW["num_decoder_layers"]
    params = jconvert.convert_t5_model(jconvert.hf_module_state_dict(hf),
                                       nl, nd)
    jmodel = jt5.T5Model(jt5.T5Dims(dropout_rate=0.0, **T5KW))
    tmodel = tt5.T5Model(tt5.T5Dims(dropout_rate=0.0, **T5KW), device="cpu")
    tmodel.load_state_dict(tconvert.convert_t5_model(
        tconvert.hf_module_state_dict(hf), nl, nd))
    return hf, jmodel, params, tmodel


def test_t5_decode_step_matches_panel_and_jax(t5_pair):
    """The cached step at every position equals the panel decoder and
    the JAX step; ``t`` as an int and as a 0-d tensor."""
    _, jmodel, params, tmodel = t5_pair
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 100, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    dec = rng.integers(2, 100, (2, 5)).astype(np.int32)
    dec[:, 0] = 0
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        panel = tmodel.decode(torch.from_numpy(dec), enc,
                              torch.from_numpy(mask))
        cross = tmodel.decoder.project_cross_kvs(enc)
        em = tt5.extend_mask(torch.from_numpy(mask))
        for as_tensor in (False, True):
            cache = tmodel.decoder.init_cache(2, 5)
            outs = []
            for t in range(5):
                emb = tmodel.shared(torch.from_numpy(dec[:, t:t + 1]).long())
                tt = torch.tensor(t) if as_tensor else t
                h, cache = tmodel.decoder.decode_step(emb, tt, cache, cross,
                                                      em)
                outs.append(h[:, 0].numpy())
            close(np.stack(outs, 1), panel.numpy())
    bound = jmodel.bind({"params": params})
    jenc = bound.encode(jnp.asarray(ids), jnp.asarray(mask))
    jcross = bound.decoder.project_cross_kvs(jenc)
    jcache = bound.decoder.init_cache(2, 5)
    jem = jt5.extend_mask(jnp.asarray(mask))
    for t in range(5):
        jh, jcache = bound.decoder.decode_step(
            bound.shared(jnp.asarray(dec[:, t:t + 1])), t, jcache, jcross,
            jem)
        close(outs[t], np.asarray(jh)[:, 0])


def test_greedy_generate_matches_jax_and_hf(t5_pair):
    hf, jmodel, params, tmodel = t5_pair
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 100, (3, 9)).astype(np.int64)
    mask = np.ones_like(ids)
    got = tgen.generate(tmodel, ids, mask, max_length=11, do_sample=False,
                        device="cpu").numpy()
    ref = np.asarray(jgen.generate(
        jmodel, params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32), jax.random.PRNGKey(0), max_length=11,
        do_sample=False))
    np.testing.assert_array_equal(got, ref)
    with torch.no_grad():
        hf_out = hf.generate(torch.tensor(ids),
                             attention_mask=torch.tensor(mask),
                             max_length=12, do_sample=False,
                             num_beams=1).numpy()[:, 1:]
    for b in range(3):
        end = (np.argmax(hf_out[b] == 1) + 1 if (hf_out[b] == 1).any()
               else hf_out.shape[1])
        np.testing.assert_array_equal(got[b, :end], hf_out[b, :end])


@pytest.mark.parametrize("top_k,top_p", [(2, 1.0), (0, 0.75), (3, 0.5),
                                         (0, 1.0)])
def test_filter_logits_equal(top_k, top_p):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 16)).astype(np.float32)
    logits[0] = np.log([0.5, 0.3, 0.15, 0.05] + [1e-6] * 12)
    ref = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampling_contract(t5_pair):
    """Seeded and deterministic; after EOS only pad; every token inside
    the top-k support of its step; top_k 1 equals greedy."""
    _, _, _, tmodel = t5_pair
    rng = np.random.default_rng(4)
    ids = rng.integers(2, 100, (2, 6)).astype(np.int64)
    mask = np.ones_like(ids)

    def run(seed, **kw):
        return tgen.generate(tmodel, ids, mask,
                             torch.Generator().manual_seed(seed),
                             max_length=10, num_return_sequences=4,
                             device="cpu", **kw).numpy()
    a, b = run(5), run(5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, 10)
    assert len({tuple(r) for r in a}) > 1
    for r in a:
        if (r == 1).any():
            assert (r[np.argmax(r == 1) + 1:] == 0).all()
    greedy = tgen.generate(tmodel, ids, mask, max_length=10,
                           num_return_sequences=4, do_sample=False,
                           device="cpu").numpy()
    np.testing.assert_array_equal(run(6, top_k=1), greedy)
    # top-k 3: each sampled token is among the 3 best of its step, read
    # from the panel decoder over the sampled prefix
    s = run(7, top_k=3)
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(ids).repeat_interleave(4, 0),
                            torch.from_numpy(mask).repeat_interleave(4, 0))
        prefix = torch.cat([torch.zeros((8, 1), dtype=torch.long),
                            torch.from_numpy(s).long()], 1)[:, :-1]
        h = tmodel.decode(prefix, enc,
                          torch.from_numpy(mask).repeat_interleave(4, 0))
        logits = tgen._lm_logits(tmodel, h)
    top3 = logits.topk(3, -1).indices.numpy()
    done = np.cumsum(s == 1, 1) - (s == 1) > 0      # steps after an EOS
    live = ~done
    assert ((top3 == s[..., None]).any(-1) | ~live).all()


# ---------------------------------------------------------------------------
# NCI dynamic-t step, trie beam, brute force
# ---------------------------------------------------------------------------

def _nci_pair(seed, kary, max_len, use_pawa=True):
    t5kw = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=2)
    nkw = dict(kary=kary, max_output_length=max_len, adaptor_layer_num=2,
               adaptor_num_heads=4, adaptor_d_ff=32, use_pawa=use_pawa)
    jmodel = jnci.NCIT5(jnci.NCIDims(t5=jt5.T5Dims(dropout_rate=0.0,
                                                   **t5kw), **nkw))
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 60, (3, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 4:] = 0
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                         jnp.asarray(mask),
                         jnp.zeros((3, max_len), jnp.int32))["params"]
    tmodel = tnci.NCIT5(tnci.NCIDims(t5=tt5.T5Dims(**t5kw), **nkw),
                        device="cpu")
    load_flax_params(tmodel, flat(params))
    return jmodel, params, tmodel, ids, mask


@pytest.mark.parametrize("use_pawa", [True, False])
def test_nci_decode_logits_step_matches_panel_and_jax(use_pawa):
    jmodel, params, tmodel, ids, mask = _nci_pair(8, 3, 5, use_pawa)
    L = 5
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 3, (3, L - 2)).astype(np.int32)
    _, dec_in = tnci.make_labels(torch.from_numpy(codes), 3, L)
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        panel, _ = tmodel.compact_logits(dec_in, enc, torch.from_numpy(mask))
        cross = tmodel.project_cross_kvs(enc)
        dec_c, pawa_c, pawa_m = tmodel.init_decode_state(3)
        tables = tmodel.head_level_tables()
        steps = []
        for t in range(L):
            lg, dec_c, pawa_c = tmodel.decode_logits_step(
                dec_in[:, t:t + 1], torch.tensor(t), dec_c, pawa_c, cross,
                pawa_m, torch.from_numpy(mask), level_tables=tables)
            steps.append(lg.numpy())
    close(np.stack(steps, 1), panel.numpy())
    bound = jmodel.bind({"params": params})
    jenc = bound.encode(jnp.asarray(ids), jnp.asarray(mask))
    jcross = bound.project_cross_kvs(jenc)
    jdec, jpawa, jmem = bound.init_decode_state(3)
    jin = jnp.asarray(dec_in.numpy())
    for t in range(L):
        jl, jdec, jpawa = bound.decode_logits_step(
            jin[:, t:t + 1], t, jdec, jpawa, jcross, jmem,
            jnp.asarray(mask))
        close(steps[t], np.asarray(jl))


DOC_IDS = [[0, 1], [0, 2], [3], [0, 1, 2], [2, 2, 1], [1], [3, 0, 0, 1]]


@pytest.fixture(scope="module")
def trie_pair():
    jmodel, params, tmodel, ids, mask = _nci_pair(11, 4, 6)
    child, term = ttrie.build_trie(DOC_IDS, 4)
    return jmodel, params, tmodel, ids, mask, child, term


def _id_sets(codes):
    return [[tuple(int(c) for c in row if c >= 0) for row in q]
            for q in np.asarray(codes)]


@pytest.mark.parametrize("nb", [3, len(DOC_IDS)])
def test_trie_beam_matches_jax(trie_pair, nb):
    jmodel, params, tmodel, ids, mask, child, term = trie_pair
    jc, jl, js = jtrie.trie_beam_search(
        jmodel, params, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(child), jnp.asarray(term), num_beams=nb, max_steps=5)
    tc, tl, ts = ttrie.trie_beam_search(tmodel, ids, mask, child, term,
                                        num_beams=nb, max_steps=5,
                                        device="cpu")
    close(ts.numpy(), np.asarray(js))
    # ids as sets per distinct score: independent of the tie order
    for q in range(ids.shape[0]):
        got = sorted(zip(np.round(ts[q].numpy(), 4), _id_sets(tc)[q],
                         tl[q].tolist()))
        want = sorted(zip(np.round(np.asarray(js)[q], 4), _id_sets(jc)[q],
                          np.asarray(jl)[q].tolist()))
        assert got == want
    valid = {tuple(s) for s in DOC_IDS} | {()}
    assert all(s in valid for q in _id_sets(tc) for s in q)


def test_trie_beam_full_width_equals_brute(trie_pair):
    """With as many beams as ids, the beam returns every id, scored as
    the teacher-forced panel scores it (tests/test_trie.py's oracle)."""
    _, _, tmodel, ids, mask, child, term = trie_pair
    K, lp = 4, 0.8
    tc, _, ts = ttrie.trie_beam_search(tmodel, ids, mask, child, term,
                                       num_beams=len(DOC_IDS), max_steps=5,
                                       device="cpu")
    ref = []
    with torch.no_grad():
        for seq in DOC_IDS:
            toks = torch.zeros((ids.shape[0], 6), dtype=torch.long)
            for t, c in enumerate(seq):
                toks[:, t + 1] = c + t * K + 2
            compact, _, _, _ = tmodel(torch.from_numpy(ids),
                                      torch.from_numpy(mask), toks)
            logp = torch.log_softmax(compact.float(), -1)
            total = sum(logp[:, t, c] for t, c in enumerate(seq))
            total = total + logp[:, len(seq), K]
            ref.append((total / (len(seq) + 1) ** lp).numpy())
    ref = np.stack(ref, 1)
    for q in range(ids.shape[0]):
        want = {tuple(DOC_IDS[j]): ref[q, j] for j in range(len(DOC_IDS))}
        got = dict(zip(_id_sets(tc)[q], ts[q].numpy()))
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], atol=1e-5)


def test_brute_force_topk_matches_jax():
    jmodel, params, tmodel, ids, mask = _nci_pair(12, 3, 5)
    jcodes, jscores = jbrute.brute_force_topk(
        jmodel, params, jnp.asarray(ids), jnp.asarray(mask), k=6)
    tcodes, tscores = tbrute.brute_force_topk(tmodel, ids, mask, k=6,
                                              batch=7, device="cpu")
    close(tscores, jscores)
    np.testing.assert_array_equal(tbrute.all_code_sequences(3, 3),
                                  jbrute.all_code_sequences(3, 3))
    # codes equal as sets per distinct score (tie-order independent)
    for q in range(ids.shape[0]):
        assert sorted(zip(np.round(tscores[q], 4), map(tuple, tcodes[q]))) \
            == sorted(zip(np.round(jscores[q], 4), map(tuple, jcodes[q])))

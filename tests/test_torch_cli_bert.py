"""The BERT family (AR2 / ERNIE twin tower) through the port's CLI against
the JAX package's (a tiny config, ``--device cpu``): ``tokenize
--style ar2``, ``gen-embeddings`` from an AR2-layout ``.pkl`` (HF
``BertModel`` names under ``ctx_model.`` and ``question_model.``, type
vocab 4, wrapped in ``model_dict``) and ``eval --nq_answer_offsets /
--nq_answer_array`` with that tower; and the hash tokenizer's ids for
the BERT styles.

Tolerances: embeddings 2e-5 (the JAX package's float32 parity
tolerance), the file's shape and size exactly; token files byte-equal;
the JSON report, ranks, ids, counts and metrics equal; beam scores in the
coarse tsv and tower scores in the hard-negative tsv 2e-5 plus 1e-6 of
the row's largest |score| (``test_torch_cli_pipeline.py``'s).

Without HF tokenizer files both packages fall back to their hash stub.
The JAX package's stub draws every style's ids from T5's 32128 words,
past the 30522 rows of a BERT word table, so its BERT tower reads NaN
for such a token (flax ``Embed`` fills out-of-range gathers); the port's
stub draws the BERT styles' ids below 30522.  The parity tests below
give the JAX side a stub of 30522 words, the port's own, so that both
CLIs see the same ids; ``test_hash_tokenizer_fits_the_bert_table``
shows the two stubs as they are."""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from mevi_tpu.cli.main import main as jmain
from mevi_tpu.data import tokenize as jtok
from mevi_tpu_torch.cli.main import main as tmain
from mevi_tpu_torch.config import (EncoderConfig, MEVIConfig, ModelConfig,
                                   RQConfig)
from mevi_tpu_torch.data import io
from mevi_tpu_torch.data import tokenize as ttok

transformers = pytest.importorskip("transformers")
from test_torch_cli_pipeline import (float_lists_close, read_rows,  # noqa
                                     reference_nci_file)

D, FF, KARY, M, LAYERS = 32, 64, 4, 2, 2
BERT_VOCAB, TYPE_VOCAB, MAX_POS = 30522, 4, 64
NDOC, LD, NQ = 48, 16, 6


@pytest.fixture(autouse=True)
def no_hf_download(monkeypatch):
    """No HF tokenizer files here: ``from_pretrained`` fails at once (no
    download attempt), so ``--allow_hash_tokenizer`` takes the stub."""
    def offline(*a, **k):
        raise OSError("no HF tokenizer files (offline test)")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        offline)


@pytest.fixture()
def jax_stub_of_bert_width(monkeypatch):
    """The JAX package's stub with the BERT word table's 30522 ids (its
    own draws from 32128, which its BERT tower reads as NaN): the
    parity tests compare the commands on the port's ids."""
    base = jtok.HashTokenizer

    def stub(vocab_size=BERT_VOCAB, **kw):
        return base(vocab_size, **kw)
    monkeypatch.setattr(jtok, "HashTokenizer", stub)


def hf_bert(seed):
    torch.manual_seed(seed)
    return transformers.BertModel(transformers.BertConfig(
        vocab_size=BERT_VOCAB, hidden_size=D, num_hidden_layers=LAYERS,
        num_attention_heads=4, intermediate_size=FF,
        type_vocab_size=TYPE_VOCAB, max_position_embeddings=MAX_POS,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()


def write_ar2_pkl(path):
    """AR2's layout: both towers' HF ``BertModel`` dicts under their
    prefixes, in a ``model_dict`` wrapper."""
    sd = {}
    for prefix, seed in (("ctx_model.", 1), ("question_model.", 2)):
        sd.update({prefix + k: v for k, v in
                   hf_bert(seed).state_dict().items()})
    torch.save({"model_dict": sd, "epoch": 0}, path)
    return sd


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = tmp_path_factory.mktemp("bert_cli")
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=M, subvector_bits=2, emb_size=D),
        model=ModelConfig(num_layers=1, num_decoder_layers=1, d_model=D,
                          d_kv=8, d_ff=FF, num_heads=4, adaptor_layer_num=1,
                          adaptor_num_heads=4, dropout_rate=0.0),
        encoder=EncoderConfig(family="bert", d_model=D, num_layers=LAYERS,
                              num_heads=4, d_ff=FF, vocab_size=BERT_VOCAB,
                              type_vocab_size=TYPE_VOCAB,
                              max_position_embeddings=MAX_POS))
    cfg.train.encode_batch_size = 16
    cfg.finalize()
    (w / "cfg.json").write_text(cfg.to_json())
    write_ar2_pkl(str(w / "ar2.pkl"))
    reference_nci_file(str(w / "nci.pt"))
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(400)]
    with open(w / "corpus.tsv", "w") as fw:
        for i in range(NDOC):
            text = " ".join(rng.choice(words, rng.integers(4, 20)))
            fw.write(f"{i}\ttitle {i % 5}\t{text}\n")
    np.save(str(w / "codes.npy"),
            rng.integers(0, KARY, (NDOC, M)).astype(np.int32))
    io.write_query_docids_tsv(str(w / "test.tsv"), [
        (" ".join(rng.choice(words, 5)), [0]) for _ in range(NQ)])
    answers = [[d % NQ, (d + 1) % NQ] if d < 30 else [] for d in range(NDOC)]
    offsets = np.zeros(NDOC + 1, np.int64)
    np.cumsum([len(a) for a in answers], out=offsets[1:])
    offsets.tofile(str(w / "inv_offsets.bin"))
    np.asarray([q for a in answers for q in a], np.int32).tofile(
        str(w / "inv_array.bin"))
    return w


def tokenize_corpus(w, main, tag):
    out = str(w / f"docs_{tag}")
    main(["tokenize", "--kind", "corpus", "--style", "ar2",
          "--input", str(w / "corpus.tsv"), "--output", out,
          "--length", str(LD), "--allow_hash_tokenizer"])
    return out


def test_gen_embeddings_from_ar2_pkl_same_as_jax(world, capsys,
                                                 jax_stub_of_bert_width):
    w = world
    outs = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        docs = tokenize_corpus(w, main, tag)
        path = str(w / f"emb_{tag}.bin")
        capsys.readouterr()
        main(["gen-embeddings", "--config", str(w / "cfg.json"),
              "--checkpoint", str(w / "ar2.pkl"), "--documents", docs,
              "--doc_length", str(LD), "--output", path]
             + (["--device", "cpu"] if tag == "port" else []))
        outs[tag] = (capsys.readouterr().out.replace(path, "<out>"),
                     io.open_embedding_memmap(path, D), docs)
    for ext in ("_tokens.bin", "_masks.bin"):
        with open(outs["port"][2] + ext, "rb") as a, \
                open(outs["jax"][2] + ext, "rb") as b:
            assert a.read() == b.read()
    tok, _ = io.open_token_memmaps(outs["port"][2], LD)
    assert int(np.asarray(tok).max()) < BERT_VOCAB
    assert outs["port"][0] == outs["jax"][0]
    assert osp.getsize(str(w / "emb_port.bin")) == \
        osp.getsize(str(w / "emb_jax.bin")) == NDOC * D * 4
    assert np.isfinite(outs["port"][1]).all()
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], atol=2e-5,
                               rtol=0)
    # the ctx side embeds the corpus: the question side gives other rows
    q_side = hf_bert(2)
    with torch.no_grad():
        ids = torch.from_numpy(np.array(tok[:4], np.int64))
        mask = torch.from_numpy(np.array(
            io.open_token_memmaps(outs["port"][2], LD)[1][:4], np.int64))
        hf_q = q_side(input_ids=ids, attention_mask=mask
                      ).last_hidden_state[:, 0].numpy()
        hf_c = hf_bert(1)(input_ids=ids, attention_mask=mask
                          ).last_hidden_state[:, 0].numpy()
    np.testing.assert_allclose(outs["port"][1][:4], hf_c, atol=2e-5, rtol=0)
    assert np.abs(outs["port"][1][:4] - hf_q).max() > 1e-2


@pytest.mark.parametrize("flags", [[], ["--bf16"], ["--host_stream"]],
                         ids=["device", "bf16", "host_stream"])
def test_eval_nq_answer_mode_with_bert_tower_same_as_jax(
        world, capsys, jax_stub_of_bert_width, flags):
    w = world
    emb = np.random.default_rng(5).normal(size=(NDOC, D)).astype(np.float32)
    io.write_embedding_memmap(str(w / "docemb.bin"), emb)
    reports = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        save = str(w / f"res_{tag}.tsv")
        main(["eval", "--config", str(w / "cfg.json"),
              "--nci_ckpt", str(w / "nci.pt"),
              "--tower_ckpt", str(w / "ar2.pkl"),
              "--embeddings", str(w / "docemb.bin"),
              "--codes", str(w / "codes.npy"),
              "--dev_tsv", str(w / "test.tsv"),
              "--num_return_sequences", "3", "--recall_num", "1,5,10",
              "--batch_size", "4", "--save_path", save,
              "--allow_hash_tokenizer",
              "--nq_answer_offsets", str(w / "inv_offsets.bin"),
              "--nq_answer_array", str(w / "inv_array.bin")] + flags
             + (["--device", "cpu"] if tag == "port" else []))
        reports[tag] = json.loads(capsys.readouterr().out)
    assert reports["port"] == reports["jax"]
    assert reports["port"]["fine"]["hitrate"]["10"] > 0
    for part in ("coarse", "fine", "hn"):
        got = read_rows(str(w / f"res_port_{part}.tsv"))
        want = read_rows(str(w / f"res_jax_{part}.tsv"))
        assert len(got) == len(want) == NQ
        for g, r in zip(got, want):
            if part == "fine":         # query, ndoc, ids, gts
                assert g == r
            else:                      # scores last
                assert g[:3] == r[:3]
                float_lists_close(g[3], r[3])


TEXTS = [" ".join(f"term{7 * i + j}" for j in range(12)) for i in range(8)]


@pytest.mark.parametrize("style", ["ar2", "cocondenser", "ance"])
def test_hash_tokenizer_vocabulary_by_style(style):
    """With the fallback, the BERT styles' ids lie below the 30522-row
    word table; the ``ance`` (T5) ids are the JAX stub's, unchanged."""
    tok = ttok.get_tokenizer(style, allow_hash_fallback=True)
    ref = jtok.get_tokenizer(style, allow_hash_fallback=True)
    got, _ = ttok.tokenize_passages([("title", t) for t in TEXTS], tok,
                                    style, 16)
    want, _ = jtok.tokenize_passages([("title", t) for t in TEXTS], ref,
                                     style, 16)
    if style == "ance":
        assert tok.vocab_size == 32128
        np.testing.assert_array_equal(got, want)
    else:
        assert tok.vocab_size == BERT_VOCAB
        assert got.max() < BERT_VOCAB <= want.max()


def test_hash_tokenizer_fits_the_bert_table():
    """The same hashed text through both packages' stubs and BERT towers
    (the same weights): the JAX stub's ids reach past the word table and
    its tower's representation is NaN there; the port's ids fit and its
    representation is finite everywhere."""
    import jax.numpy as jnp
    from mevi_tpu.models import convert as jconv
    from mevi_tpu.models.twin_tower import tower_from_config as jtower
    from mevi_tpu_torch.models import convert as tconv
    from mevi_tpu_torch.models.twin_tower import tower_from_config
    enc = EncoderConfig(family="bert", d_model=D, num_layers=LAYERS,
                        num_heads=4, d_ff=FF, vocab_size=BERT_VOCAB,
                        type_vocab_size=TYPE_VOCAB,
                        max_position_embeddings=MAX_POS)
    sd = {k: v.numpy() for k, v in hf_bert(3).state_dict().items()}
    tj = jtower(enc)
    pj = jconv.convert_bert_model(sd, LAYERS)
    tt = tower_from_config(enc, device="cpu")
    tt.module.load_state_dict(tconv.convert_bert_model(sd, LAYERS))
    jt = jtok.get_tokenizer("ar2", allow_hash_fallback=True)
    pt = ttok.get_tokenizer("ar2", allow_hash_fallback=True)
    j_ids, j_mask = jtok.tokenize_queries(TEXTS, jt, 16)
    p_ids, p_mask = ttok.tokenize_queries(TEXTS, pt, 16)
    bad = (j_ids >= BERT_VOCAB).any(1)
    assert bad.any() and not bad.all()
    j_rep = np.asarray(tj.rep(pj, jnp.asarray(j_ids), jnp.asarray(j_mask)))
    assert np.isnan(j_rep[bad]).all(1).all()
    assert np.isfinite(j_rep[~bad]).all()
    assert p_ids.max() < BERT_VOCAB
    with torch.no_grad():
        p_rep = tt.rep(torch.from_numpy(p_ids), torch.from_numpy(p_mask))
    assert torch.isfinite(p_rep).all()
    # where the JAX stub's ids fit, the two representations agree
    with torch.no_grad():
        same = tt.rep(torch.from_numpy(j_ids[~bad]),
                      torch.from_numpy(j_mask[~bad])).numpy()
    np.testing.assert_allclose(same, j_rep[~bad], atol=2e-5, rtol=0)

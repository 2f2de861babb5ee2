"""Port parity for the host side: ``utils/native`` (the C++ library
through the port's own loader, and the numpy fallbacks),
``data/tokenize`` and ``data/prepare`` against the JAX package's, and
the ``prepare`` / ``tokenize`` commands of both CLIs on the same input
files: equal arrays, byte-identical files, the same printed lines."""

import numpy as np
import pytest

from mevi_tpu.cli.main import main as jmain
from mevi_tpu.data import prepare as jP
from mevi_tpu.data import tokenize as jtok
from mevi_tpu.utils import native as jnat
from mevi_tpu_torch.cli.main import main as tmain
from mevi_tpu_torch.data import prepare as tP
from mevi_tpu_torch.data import tokenize as ttok
from mevi_tpu_torch.utils import native as tnat

PASSAGES = ["The Quick brown fox, jumps!", "lazy dog sleeps",
            "Hello  World: héllo wörld", "naïve café — déjà vu",
            "answers: brown fox; world"]
ANSWERS = [["brown fox"], ["world", "Hello"], [], ["café"],
           ["zzz", "déjà vu"]]


@pytest.fixture(autouse=True)
def no_hf_download(monkeypatch):
    """No HF tokenizer files here: ``from_pretrained`` fails at once (no
    download attempt), so ``--allow_hash_tokenizer`` takes the stub."""
    import transformers

    def offline(*a, **k):
        raise OSError("no HF tokenizer files (offline test)")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        offline)


@pytest.fixture(params=["native", "fallback"])
def mode(request, monkeypatch):
    """Each case runs through the library and through the numpy
    fallbacks (both packages' loaders patched to find no library)."""
    if request.param == "native":
        if tnat.ensure_built() is None or jnat.ensure_built() is None:
            pytest.skip("native build unavailable")
    else:
        monkeypatch.setattr(tnat, "ensure_built", lambda force=False: None)
        monkeypatch.setattr(jnat, "ensure_built", lambda force=False: None)
    return request.param


def test_library_path_is_the_ports_own():
    assert tnat._SO_PATH == jnat._SO_PATH      # the same native/ of this repo
    assert "mevi_tpu_torch" not in tnat._SO_PATH
    assert tnat.__file__ != jnat.__file__


def test_build_csr(mode):
    codes = np.random.default_rng(0).integers(0, 4, (300, 3)).astype(
        np.int32)
    off, ids = tnat.build_csr(codes, 4)
    joff, jids = jnat.build_csr(codes, 4)
    np.testing.assert_array_equal(off, joff)
    assert off.dtype == joff.dtype == np.int64
    for c in range(64):                  # members equal as sets
        assert set(ids[off[c]:off[c + 1]]) == set(jids[off[c]:off[c + 1]])


def test_match_answers_and_sets(mode):
    pas = [p.lower().encode() for p in PASSAGES]
    for ans in ANSWERS:
        a = [x.lower().encode() for x in ans]
        np.testing.assert_array_equal(tnat.match_answers(pas, a),
                                      jnat.match_answers(pas, a))
    assert tnat.match_answer_sets(PASSAGES, ANSWERS) == \
        jnat.match_answer_sets(PASSAGES, ANSWERS)


def test_tokenize_hashes_and_line_offsets(mode):
    for text in PASSAGES:
        np.testing.assert_array_equal(tnat.tokenize_hashes(text),
                                      jnat.tokenize_hashes(text))
    for data in (b"a\tx\nbb\tyy\nccc\tzzz\n", b"a\nb", b"", b"\n\n"):
        np.testing.assert_array_equal(tnat.line_offsets(data),
                                      jnat.line_offsets(data))


def test_sample_cluster_negatives(mode):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (120, 2)).astype(np.int32)
    off, ids = tnat.build_csr(codes, 4)
    cluster_of = (codes[:, 0] * 4 + codes[:, 1]).astype(np.int64)
    pos = rng.integers(0, 120, 16).astype(np.int32)
    got = tnat.sample_cluster_negatives(off, ids, cluster_of, pos, 5, seed=3)
    np.testing.assert_array_equal(
        got, jnat.sample_cluster_negatives(off, ids, cluster_of, pos, 5,
                                           seed=3))
    assert (got != pos[:, None]).all()


@pytest.mark.parametrize("word_boundary", [True, False])
def test_build_answer_arrays(mode, word_boundary):
    got = tP.build_answer_arrays(PASSAGES, ANSWERS, word_boundary)
    want = jP.build_answer_arrays(PASSAGES, ANSWERS, word_boundary)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# ---------------------------------------------------------------------------
# tokenize and prepare
# ---------------------------------------------------------------------------

ROWS = [("Title A", "some passage text here"), ("", "another one"),
        ("T", "")]


@pytest.mark.parametrize("style", ["ance", "ar2", "cocondenser"])
def test_tokenize_passages_and_queries(style):
    for tok, ref in ((ttok.HashTokenizer(), jtok.HashTokenizer()),):
        t, m = ttok.tokenize_passages(ROWS, tok, style, 8, batch_size=2)
        jt_, jm = jtok.tokenize_passages(ROWS, ref, style, 8, batch_size=2)
        np.testing.assert_array_equal(t, jt_)
        np.testing.assert_array_equal(m, jm)
        q, qm = ttok.tokenize_queries(["what is x", "who"], tok, 4)
        jq, jqm = jtok.tokenize_queries(["what is x", "who"], ref, 4)
        np.testing.assert_array_equal(q, jq)
        assert q.dtype == jq.dtype == np.int32
        assert tok.batch_decode(q) == ref.batch_decode(jq)


def test_get_tokenizer_without_hf_files():
    """No cached HF files offline: a loud error, the hash stub only when
    allowed (as the JAX package)."""
    with pytest.raises(RuntimeError, match="allow_hash_tokenizer"):
        ttok.get_tokenizer("ance")
    assert isinstance(ttok.get_tokenizer("ar2", allow_hash_fallback=True),
                      ttok.HashTokenizer)


def test_prepare_functions(tmp_path):
    rows = [(0, "short title", "a b c d e f g h"), (3, "", "x y"),
            (5, "t", " ".join(f"w{i}" for i in range(3500)))]
    assert tP.doc_aug_spans(rows, seed=1, spans_per_doc=3, span_len=4) == \
        jP.doc_aug_spans(rows, seed=1, spans_per_doc=3, span_len=4)
    assert tP.qg_subset(list(range(20)), 5) == jP.qg_subset(list(range(20)),
                                                            5)
    for style in ("ance", "ar2", "cocondenser"):
        assert tP.doc_as_query_text("T", "C", style) == \
            jP.doc_as_query_text("T", "C", style)
    qg = [("q a", 1), ("  ", 1), ("q a", 1), ("q b", 2), ("q c", 2)]
    assert tP.qg_repair(qg, 2) == jP.qg_repair(qg, 2)
    kept, remap = tP.sample_corpus(50, 0.3, seed=2)
    jkept, jremap = jP.sample_corpus(50, 0.3, seed=2)
    np.testing.assert_array_equal(kept, jkept)
    assert remap == jremap
    pairs = [("q", int(d)) for d in range(0, 50, 3)]
    assert tP.remap_pairs(pairs, remap) == jP.remap_pairs(pairs, jremap)
    # compose_train_data over a tiny origin dir
    from mevi_tpu_torch.data.io import write_query_docids_tsv
    write_query_docids_tsv(str(tmp_path / "train_mevi.tsv"),
                           [("q1", [1]), ("q2", [2])])
    write_query_docids_tsv(str(tmp_path / "qg5.tsv"), [("g1", [1])])
    write_query_docids_tsv(str(tmp_path / "doc_aug.tsv"), [("sp", [2])])
    corpus = tmp_path / "corpus.tsv"
    corpus.write_text("1\tT1\tc one\n2\tT2\tc two\n")
    for recipe in ("gtq", "gtq_doc_qg5", "qg5_aug"):
        assert tP.compose_train_data(str(tmp_path), recipe, str(corpus)) \
            == jP.compose_train_data(str(tmp_path), recipe, str(corpus))


def test_nq_readers(tmp_path):
    import json
    psgs = tmp_path / "psgs.tsv"
    psgs.write_text("id\ttext\ttitle\n1\tfirst text\tT1\n2\tsecond\tT2\n")
    assert tP.nq_corpus_rows(str(psgs)) == jP.nq_corpus_rows(str(psgs))
    bi = tmp_path / "bi.json"
    bi.write_text(json.dumps([{"question": "who’s x", "positive_ctxs": [
        {"passage_id": "2"}, {"passage_id": "1"}]}]))
    assert tP.nq_biencoder_pairs(str(bi)) == jP.nq_biencoder_pairs(str(bi))


# ---------------------------------------------------------------------------
# the CLI commands, both packages on the same files
# ---------------------------------------------------------------------------

def raw_marco(raw):
    raw.mkdir()
    (raw / "train.query.txt").write_text("1\tq one\n2\tq two\n4\tq four\n")
    (raw / "qrels.train.tsv").write_text(
        "1\t0\t10\t1\n2\t0\t20\t1\n4\t11\n")
    (raw / "dev.query.txt").write_text("3\tq three\n5\tq five\n")
    (raw / "qrels.dev.tsv").write_text(
        "3\t0\t30\t1\n5\t0\t2\t1\n3\t0\t31\t1\n")
    words = [f"w{i}" for i in range(40)]
    (raw / "corpus.tsv").write_text("".join(
        f"{d}\tTitle {d}\t{' '.join(words[d:d + 12])}\n" for d in range(25)))


def read_bytes(d, names):
    return {n: (d / n).read_bytes() for n in names}


def test_prepare_and_tokenize_cli_byte_identical(tmp_path, capsys):
    raw_marco(tmp_path / "raw")
    outs = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        origin = tmp_path / f"origin_{tag}"
        main(["prepare", "--raw_dir", str(tmp_path / "raw"),
              "--origin_dir", str(origin), "--doc_aug"])
        for kind, src, length in (
                ("corpus", str(tmp_path / "raw" / "corpus.tsv"), 16),
                ("queries", str(origin / "train_mevi.tsv"), 6)):
            main(["tokenize", "--kind", kind, "--input", src,
                  "--output", str(origin / f"tok_{kind}"),
                  "--length", str(length), "--allow_hash_tokenizer"])
        printed = capsys.readouterr().out.replace(str(origin), "<origin>")
        outs[tag] = (printed, read_bytes(origin, sorted(
            p.name for p in origin.iterdir())))
    assert outs["port"][0] == outs["jax"][0]
    assert set(outs["port"][1]) == set(outs["jax"][1])
    assert len(outs["port"][1]) == 7     # 3 tsvs + 2 x (tokens, masks)
    for name, data in outs["jax"][1].items():
        assert outs["port"][1][name] == data, name

"""Port parity: ``mevi_tpu_torch.data.datasets``, the token/packed-query
memmaps of ``data.io`` and ``mevi_tpu_torch.utils`` against the JAX
package's, on the CPU (the fixtures of tests/test_datasets_ckpt.py and
tests/test_utils.py).

Batches and negatives drawn with one seed are equal array for array."""

import json
import os.path as osp
import threading
import time

import numpy as np
import pytest
import torch

from mevi_tpu.data import datasets as JD
from mevi_tpu.data import io as jio
from mevi_tpu.utils import logging as jlog
from mevi_tpu_torch.config import MEVIConfig
from mevi_tpu_torch.data import datasets as TD
from mevi_tpu_torch.data import io as tio
from mevi_tpu_torch.utils.logging import MetricsLogger, run_name
from mevi_tpu_torch.utils.timers import SectionTimers, profiler_trace


def same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if isinstance(x, tuple):          # alternating_batches' (tag, batch)
            assert x[0] == y[0]
            x, y = x[1], y[1]
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    return a


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_nci_dataset_same_batches(shuffle, drop_last):
    rng = np.random.default_rng(0)
    args = dict(query_ids=np.arange(40).reshape(10, 4).astype(np.int32),
                query_mask=np.ones((10, 4), np.int32),
                codes=rng.integers(0, 4, size=(10, 2)).astype(np.int32))
    out = same_batches(
        TD.NCIDataset(**args).batches(4, np.random.default_rng(1), shuffle,
                                      drop_last),
        JD.NCIDataset(**args).batches(4, np.random.default_rng(1), shuffle,
                                      drop_last))
    assert len(out) == (2 if drop_last else 3)


@pytest.mark.parametrize("codes", [
    np.r_[np.zeros((10, 2)), np.c_[np.ones(10), np.zeros(10)]],  # 2 x 10
    np.array([[0, 0], [0, 1], [1, 0], [2, 2]]),     # singleton fallback
    np.array([[0, 0], [3, 3], [3, 3]]),             # corpus fallback
])
def test_cluster_negative_sampler_same_draws(codes):
    codes = codes.astype(np.int32)
    ts = TD.ClusterNegativeSampler(codes, kary=4)
    js = JD.ClusterNegativeSampler(codes, kary=4)
    np.testing.assert_array_equal(ts.offsets, np.asarray(js.offsets))
    np.testing.assert_array_equal(ts.doc_ids, np.asarray(js.doc_ids))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for pos in range(len(codes)):
        for n in (1, 2, len(codes) - 1):
            np.testing.assert_array_equal(ts.sample(pos, n, r1),
                                          js.sample(pos, n, r2))


def _twin_args(cls_mod, rng):
    ndoc = 30
    codes = rng.integers(0, 2, size=(ndoc, 2)).astype(np.int32)
    return dict(query_ids=np.arange(32).reshape(8, 4).astype(np.int32),
                query_mask=np.ones((8, 4), np.int32),
                pos_doc=rng.integers(0, ndoc, 8),
                doc_tokens=np.arange(ndoc * 6).reshape(ndoc, 6).astype(
                    np.int32),
                doc_masks=np.ones((ndoc, 6), np.int32),
                sampler=cls_mod.ClusterNegativeSampler(codes, kary=2))


def test_twin_dataset_same_batches():
    tds = TD.TwinDataset(n_neg=3, **_twin_args(TD, np.random.default_rng(0)))
    jds = JD.TwinDataset(n_neg=3, **_twin_args(JD, np.random.default_rng(0)))
    out = same_batches(tds.batches(4, np.random.default_rng(2)),
                       jds.batches(4, np.random.default_rng(2)))
    assert out[0]["doc_ids"].shape == (16, 6)
    assert out[0]["doc_index"].shape == (4, 4)


@pytest.mark.parametrize("with_codes,n_neg", [(False, 3), (True, 0)])
def test_joint_dataset_same_batches(with_codes, n_neg):
    kw = {}
    for mod in (TD, JD):
        a = _twin_args(mod, np.random.default_rng(4))
        if with_codes:
            a["doc_codes"] = np.arange(60).reshape(30, 2)
        kw[mod] = a
    same_batches(
        TD.JointDataset(n_neg=n_neg, **kw[TD]).batches(
            4, np.random.default_rng(5)),
        JD.JointDataset(n_neg=n_neg, **kw[JD]).batches(
            4, np.random.default_rng(5)))


def test_file_negative_sampler_same_draws(tmp_path):
    p = str(tmp_path / "hn.tsv")
    tio.write_hardneg_results(p, [("q1", [], [3, 4, 5], [2.0, 1.0, 0.5]),
                                  ("q2", [], [7, 8], [0.1, 0.2])])
    ts = TD.FileNegativeSampler.from_hardneg_tsv(p, num_docs=100)
    js = JD.FileNegativeSampler.from_hardneg_tsv(p, num_docs=100)
    uni = TD.FileNegativeSampler({"q1": [3, 4, 5]}, num_docs=100)
    uni_j = JD.FileNegativeSampler({"q1": [3, 4, 5]}, num_docs=100)
    r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
    for q, pos, n in (("q1", 4, 2), ("q1", 0, 5), ("q2", 7, 3),
                      ("zzz", 0, 3)):
        np.testing.assert_array_equal(ts.sample(q, pos, n, r1),
                                      js.sample(q, pos, n, r2))
        np.testing.assert_array_equal(uni.sample(q, pos, n, r1),
                                      uni_j.sample(q, pos, n, r2))


def test_alternating_batches_same_order():
    a = [{"x": np.array([i])} for i in range(5)]
    b = [{"y": np.array([i])} for i in range(3)]
    out = same_batches(TD.alternating_batches(a, b, (2, 1)),
                       JD.alternating_batches(a, b, (2, 1)))
    assert [k for k, _ in out] == ["a", "a", "b", "a", "a", "b", "a"]


def test_device_prefetch_order_and_tensors():
    it = ({"x": np.array([i, i]), "tag": f"t{i}"} for i in range(5))
    out = list(TD.device_prefetch(it, size=2, device="cpu"))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    assert [b["tag"] for b in out] == [f"t{i}" for i in range(5)]


def test_host_prefetch_order_and_errors():
    assert list(TD.host_prefetch(iter(range(10)), size=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("worker died")

    out = []
    with pytest.raises(ValueError, match="worker died"):
        for x in TD.host_prefetch(boom(), size=2):
            out.append(x)
    assert out == [1]


def test_host_prefetch_abandoned_consumer_stops_worker():
    n_before = threading.active_count()
    gen = TD.host_prefetch(iter(range(1000)), size=2)
    assert next(gen) == 0
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before


def test_token_memmaps_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 1000, size=(6, 8))
    msk = (rng.random((6, 8)) < 0.5).astype(np.int64)
    tio.write_token_memmaps(str(tmp_path / "t"), tok, msk)
    jt, jm = jio.open_token_memmaps(str(tmp_path / "t"), doc_length=8)
    np.testing.assert_array_equal(jt, tok)
    np.testing.assert_array_equal(jm, msk)
    jio.write_token_memmaps(str(tmp_path / "j"), tok, msk)
    tt, tm = tio.open_token_memmaps(str(tmp_path / "j"), doc_length=8)
    np.testing.assert_array_equal(tt, tok)
    np.testing.assert_array_equal(tm, msk)
    assert tt.dtype == np.int64 and tt.shape == (6, 8)


def test_packed_queries_round_trip(tmp_path):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 500, size=(5, 4))
    mask = np.ones((5, 4), np.int64)
    docids = rng.integers(0, 99, size=5)
    packed = tio.pack_queries(ids, mask, docids)
    want = jio.pack_queries(ids, mask, docids)
    assert packed.dtype == want.dtype and packed.tobytes() == want.tobytes()
    p = str(tmp_path / "q.bin")
    packed.tofile(p)
    np.testing.assert_array_equal(tio.open_packed_queries(p, 4), want)
    np.testing.assert_array_equal(jio.open_packed_queries(p, 4),
                                  tio.open_packed_queries(p, 4))


def test_section_timers():
    t = SectionTimers(sync=False)
    with t.section("a"):
        sum(range(1000))
    with t.section("a", block_on=[torch.ones(3), {"b": torch.zeros(2)}]):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    with SectionTimers().section("synced"):
        pass


def test_timers_dump_and_profiler_trace(tmp_path):
    t = SectionTimers(sync=False)
    with t.section("x"):
        pass
    p = str(tmp_path / "times.json")
    t.dump(p)
    assert "x" in json.load(open(p))
    with profiler_trace(None):
        pass
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert list((tmp_path / "trace").iterdir())


def test_metrics_logger_matches_jax(tmp_path):
    recs = {}
    for tag, cls in (("t", MetricsLogger), ("j", jlog.MetricsLogger)):
        lg = cls(str(tmp_path / tag), "run1")
        lg.log({"loss": np.float32(1.5), "note": "hi", "n": 3,
                "t": torch.tensor(0.25)}, step=3)
        lg.close()
        with open(osp.join(str(tmp_path / tag), "run1_metrics.jsonl")) as f:
            rec = json.loads(f.read())
        rec.pop("ts")
        recs[tag] = rec
    assert recs["t"] == recs["j"]
    assert recs["t"]["loss"] == 1.5 and recs["t"]["step"] == 3


def test_run_name_matches_jax():
    from mevi_tpu.config import MEVIConfig as JCfg
    name = run_name("nci", MEVIConfig().finalize())
    assert name == jlog.run_name("nci", JCfg().finalize())
    assert "rq4x5" in name and "marco" in name

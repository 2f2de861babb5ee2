"""The port's data-parallel EMA joint step on the CPU (NCI + T5 tower +
codebooks, the EMA statistics of the gathered batch): two gloo ranks
(``launch_local``, one spawn for the module), each given its half of
every batch, against the single-rank port step on the whole batch and
against the JAX package's jitted step with the batch sharded over
``mesh8``'s data axis.

Cases: ``pq_loss`` label, ce with the reconstruction loss, kl, kl with
batch negatives (every row of the global batch) and mse with sample
negatives, from an EMA state with no dead centroid (so the restart
draws nothing); and the restart itself (a zero EMA state: every
centroid restarts from rows of the gathered batch drawn by a generator
seeded alike on the ranks), against the single-rank port only (JAX's
draws are its own).  Tolerances as ``test_torch_parallel_train.py``'s
(``torch_parallel_jax.close_trees``); EMA statistics at 2e-5 and a
relative 1e-6."""

import pytest

import torch_parallel_jax as PJ
import torch_parallel_ranks as R
from mevi_tpu_torch.parallel.mesh import launch_local

CASES = [c for c in PJ.CASES if c[0] == "ema"]


@pytest.fixture(scope="module")
def setup():
    return PJ.build_inputs(("ema",))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    inp, _ = setup
    return launch_local(R.train_rank, 2, "gloo", "cpu", inp,
                        workdir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("name", [n for _, n in CASES])
def test_data_parallel_joint_step(ranks, setup, mesh8, name):
    PJ.check_case(ranks, setup, mesh8, "ema", name)


def test_data_parallel_ema_restart(ranks, setup):
    """Every centroid restarts: the rows come from the gathered batch by
    the generator seeded alike on both ranks, so the data-parallel
    codebooks and EMA state are the single-rank step's."""
    inp, _ = setup
    PJ.check_ranks(ranks, "ema_restart", PJ.single(inp, "ema_restart"))

"""The port's data-parallel NCI and twin steps on the CPU: two gloo
ranks (``launch_local``, one spawn for the module), each given its half
of every batch, against the single-rank port step on the whole batch and
against the JAX package's jitted step with the batch sharded over
``mesh8``'s data axis (jit computes the global batch's step).

Cases: the NCI step without R-drop and with each R-drop loss (KL, L2,
Contrast: in-batch negatives over the whole doubled batch); the twin
step (in-batch negatives over the global batch).  The EMA joint step is
``test_torch_parallel_joint.py``'s.

Two steps each (warmup 0).  Parameters after the steps: bitwise equal
across the ranks, and at the JAX package's float32 2e-5 from the
single-rank port and from JAX (``torch_parallel_jax.close_trees``: the
key slice of PAWA's ``in_proj_bias`` has no true gradient and is held
to Adam's lr bound); metrics at 2e-5.  Adam's first moments (gradient
sums that keep their scale, which Adam's updates lose) at 2e-5 from the
single-rank port's.

Tighter, against one process in the ranks' row layout (each half's
forward in turn, autograd summing the halves' gradients): Adam's first
moments within 4 times that process's distance from itself with the
halves swapped (relative L2 over every parameter; at least float32's
epsilon), parameters likewise, metrics at 1e-6 relative."""

import numpy as np
import pytest

import torch_parallel_jax as PJ
import torch_parallel_ranks as R
from mevi_tpu_torch.parallel.mesh import launch_local

CASES = [c for c in PJ.CASES if c[0] in ("nci", "twin")]
IN_PARTS = ("nci", "twin")      # the cases without R-drop's doubled batch
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def setup():
    return PJ.build_inputs(("nci", "twin"))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    inp, _ = setup
    return launch_local(R.train_rank, 2, "gloo", "cpu",
                        dict(inp, in_parts=IN_PARTS),
                        workdir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("kind,name", CASES, ids=[c for _, c in CASES])
def test_data_parallel_step(ranks, setup, mesh8, kind, name):
    PJ.check_case(ranks, setup, mesh8, kind, name)


def _flat(tree):
    return np.concatenate([np.asarray(tree[k], np.float64).ravel()
                           for k in sorted(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", IN_PARTS)
def test_data_parallel_step_in_rank_layout(ranks, name):
    ref, swapped = ranks[0]["in_parts", name]
    m_ref, p_ref = _flat(ref[3]), _flat(ref[0])
    m_tol = 4 * max(_rel(_flat(swapped[3]), m_ref), EPS32)
    p_tol = 4 * max(np.abs(_flat(swapped[0]) - p_ref).max(), EPS32)
    for res in ranks:
        p, m, _, a = res[name]
        assert _rel(_flat(a), m_ref) <= m_tol
        assert np.abs(_flat(p) - p_ref).max() <= p_tol
        for k, v in m.items():
            np.testing.assert_allclose(v, ref[1][k], rtol=1e-6, err_msg=k)

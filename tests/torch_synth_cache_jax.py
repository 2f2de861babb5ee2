"""The JAX package's synthetic-corpus cache at a directory of the caller's.

``mevi_tpu.data.synth.fit_rq_codes`` and ``SynthSpec.cache_dir`` default
to one fixed directory outside the checkout, which every checkout on a
host shares and whose ``np.save`` writes are not atomic.  The parity
tests point both at a directory of their own, in process through
:func:`jax_synth_cache`, and for a JAX script run as a process of its
own through this file:

    python tests/torch_synth_cache_jax.py BASE SCRIPT

runs ``SCRIPT`` as ``__main__`` with the cache under ``BASE``."""

import contextlib
import functools
import os.path as osp
import runpy
import sys
from unittest import mock

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@contextlib.contextmanager
def jax_synth_cache(base):
    """``fit_rq_codes`` and ``SynthSpec.cache_dir`` default to ``base``
    for the span of the block."""
    from mevi_tpu.data import synth
    fit, cache_dir = synth.fit_rq_codes, synth.SynthSpec.cache_dir
    with mock.patch.object(synth, "fit_rq_codes",
                           functools.partial(fit, cache_base=base)), \
            mock.patch.object(synth.SynthSpec, "cache_dir",
                              lambda self, b=base: cache_dir(self, b)):
        yield


if __name__ == "__main__":
    base, script = sys.argv[1:3]
    sys.argv = [script] + sys.argv[3:]
    sys.path[0] = osp.dirname(osp.abspath(script))
    sys.path.insert(1, REPO)
    with jax_synth_cache(base):
        runpy.run_path(script, run_name="__main__")

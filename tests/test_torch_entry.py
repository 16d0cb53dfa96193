"""The port's entry points (``futuresdr_tpu_torch/entry.py``) against the
repository root's ``__graft_entry__.py`` on the CPU: ``entry()``'s MCLDNN
forward with the JAX weights carried across by ``convert.mcldnn_from_flax``,
and ``dryrun_multichip(8)`` in a fresh process on 8 logical CPU devices
(config ``virtual_devices``), which loads neither JAX nor the JAX package.
The counterpart of ``tests/test_parallel.py``'s ``test_graft_entry_points``;
a file of its own because the reference's full-width init takes seconds.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from futuresdr_tpu_torch.convert import mcldnn_from_flax
from futuresdr_tpu_torch.entry import entry

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = str(Path(__file__).resolve().parents[1])


def test_entry_matches_the_jax_entry():
    """``entry()``'s batch is the JAX ``entry()``'s, and with the JAX weights
    carried across its logits are the JAX forward's (atol 1e-4, as the
    pretrained weights in ``tests/test_torch_mcldnn.py``)."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import entry as jax_entry
    jfn, (jparams, jbatch) = jax_entry()
    want = np.asarray(jax.jit(jfn)(jparams, jbatch))
    fn, (model, batch) = entry(device="cpu")
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    model.load_state_dict(mcldnn_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    got = fn(model, batch).numpy()
    assert got.shape == (8, 11)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_dryrun_multichip_runs_on_8_cpu_devices_alone():
    """``dryrun_multichip(8)`` in a fresh process on 8 logical CPU devices,
    its asserts the reference's; the process loads neither JAX nor the JAX
    package."""
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from futuresdr_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(8, device='cpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'futuresdr_tpu')]\n"
            "print('bad', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

"""Training on a mesh across gloo ranks of the CPU (one subprocess each,
``tests/torch_mesh_ranks.py``), against one device and the JAX package.

* Against JAX: the port's (2, 2) f32 steps on the smoke llama3-8b (4 gloo
  ranks, ``torch_mesh_ranks.py train_jax``) match the JAX package's
  one-device steps from the same weights at ``test_f32_adamw_steps_match_
  jax``'s budget (losses 1e-4 relative, parameters 5e-3): JAX's own
  sharded step does not run here, and XLA's partitioning does not change
  the math.
* Gloo ranks against one device (``torch_mesh_ranks.py train``: dense
  case (b) and (c) on (2, 2), (1, 4), (4, 1) and (2, 2, 1), RG-LRU, SSD
  and MoE on (2, 2), microbatches (two-hop batches too, whose rows hold
  unequal token counts), MoE groups = the data shards; its
  ``train_case`` states the budgets).
* Checkpoints and the CLI (``torch_mesh_ranks.py train_cli``: 2 ranks).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.convert import _named_leaves, from_jax_params

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline as JPipe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as JTR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ranks(job: str, *args, timeout: int = 400) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_mesh_ranks.py"), job,
                           *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert "RESULT ok" in proc.stdout, proc.stdout
    return proc.stdout


def test_mesh_steps_match_jax_one_device(tmp_path):
    """The port's (2, 2) f32 steps (FSDP over 'data', case (b) and the
    vocabulary over 'model') against the JAX package's one-device
    ``build_train_step(cfg, ocfg, None)`` from the same weights."""
    jc = dataclasses.replace(C.get_smoke("llama3-8b"), vocab_size=512,
                             dtype=jnp.float32)
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512,
                             dtype=torch.float32)
    p = JT.init_params(jc, jax.random.PRNGKey(3))
    torch.save(from_jax_params(jax.tree.map(np.asarray, p), tc).state_dict(),
               tmp_path / "weights.pt")
    pipe = JPipe(8, 32, seed=4)
    host = [pipe.get_batch(i) for i in range(2)]
    np.savez(tmp_path / "batches.npz",
             **{f"{i}_{k}": v for i, b in enumerate(host)
                for k, v in b.items()})
    _ranks("train_jax", tmp_path)
    out = torch.load(tmp_path / "out.pt")
    jstep = JTR.build_train_step(jc, jopt.AdamWConfig(lr=1e-3), None,
                                 donate=False)
    js = jopt.init(p)
    for i, b in enumerate(host):
        p, js, jm = jstep(p, js, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(out["losses"][i], float(jm["loss"]),
                                   rtol=1e-4)
    for n, a in _named_leaves(jax.tree.map(np.asarray, p), jc):
        np.testing.assert_allclose(out["params"][n].numpy(), a, atol=5e-3,
                                   rtol=0, err_msg=n)


def test_mesh_training_on_gloo_ranks():
    out = _ranks("train", timeout=600)
    assert out.count(" ok: ") == 15


def test_mesh_cli_checkpoints_resume_across_meshes(tmp_path):
    assert "train cli ok" in _ranks("train_cli", tmp_path)

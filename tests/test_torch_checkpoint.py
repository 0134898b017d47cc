"""The port's checkpoints (``repro_torch.training.checkpoint``) and restart
(``launch/train.py --resume``), and the checkpoint cases of the reference's
``tests/test_training_and_checkpoint.py``.

The format is the reference's: ``step_<n>/manifest.json`` + ``shard_0.npz``
of ``<path>@full`` arrays, bf16 stored as its ``uint16`` bits under a
``bfloat16`` manifest dtype, ``LATEST`` written last, so the reference's
``restore`` reads the port's files (leaf paths differ: the port names
leaves by its parameter names).  Restart is held bitwise: 2N steps
straight against N steps, a save, a restore into fresh objects and N
more.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import checkpoint as jck  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLMPipeline,  # noqa: E402
                                       device_put_batch)
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402

CFG = dataclasses.replace(TC.get_smoke("smollm-135m"), vocab_size=512)


def _trained(steps: int, seed: int = 0):
    """A bf16 smoke model and its AdamW state after ``steps`` steps."""
    model = TT.init_params(CFG, torch.Generator().manual_seed(seed))
    state = opt.init(model)
    step = TR.build_train_step(CFG, opt.AdamWConfig(lr=1e-2, total_steps=8,
                                                    warmup_steps=1))
    pipe = SyntheticLMPipeline(4, 32, seed=seed)
    for s in range(steps):
        step(model, state, device_put_batch(pipe.get_batch(s), "cpu"))
    return model, state, step, pipe


def _fresh():
    model = TT.Transformer(CFG)
    return model, opt.init(model)


def _bits(x) -> np.ndarray:
    if isinstance(x, int):
        return np.array([x])
    t = x.detach()
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]).numpy()


def _assert_bitwise(tree_a, tree_b):
    a, b = ck._flatten(tree_a), ck._flatten(tree_b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    model, state, _, _ = _trained(2)
    tree = {"params": model, "opt": state}
    path = ck.save(str(tmp_path), 7, tree, extra={"step": 7})
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert ck.latest_step(str(tmp_path)) == 7
    like = dict(zip(("params", "opt"), _fresh()))
    restored, extra = ck.restore(str(tmp_path), 7, like)
    assert extra == {"step": 7} and restored is like
    assert like["opt"].step == 2
    _assert_bitwise(tree, like)

    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    leaves = man["leaves"]
    assert leaves["params/embed"] == {"shape": [512, 48],
                                      "dtype": "bfloat16"}
    assert leaves["opt/master/embed"]["dtype"] == "float32"
    assert leaves["opt/step"] == {"shape": [], "dtype": "int32"}
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert sorted(z.files) == sorted(f"{p}@full" for p in leaves)
        assert z["params/embed@full"].dtype == np.uint16
    assert not os.path.exists(os.path.join(str(tmp_path), "tmp_7"))


def test_checkpoint_prune_and_latest(tmp_path):
    model, _ = _fresh()
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, {"p": model.final_norm}, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    assert ck.latest_step(str(tmp_path)) == 4
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_restore_refuses_another_tree(tmp_path):
    model, state, _, _ = _trained(1)
    ck.save(str(tmp_path), 1, {"params": model, "opt": state})
    other = dataclasses.replace(CFG, d_model=64)
    m2 = TT.Transformer(other)
    with pytest.raises(ValueError, match="params/embed"):
        ck.restore(str(tmp_path), 1, {"params": m2, "opt": opt.init(m2)})
    with pytest.raises(ValueError, match="other leaves"):
        ck.restore(str(tmp_path), 1, {"params": model})


def test_reference_restore_reads_the_ports_checkpoint(tmp_path):
    """The reference's ``restore``, given the port's tree structure, reads
    the port's checkpoint leaf for leaf (bf16, f32, the int32 step)."""
    model, state, _, _ = _trained(1)
    ck.save(str(tmp_path / "port"), 1, {"params": model, "opt": state})
    flat = ck._flatten({"params": model, "opt": state})
    abstract = {"params": {}, "opt": {"master": {}, "m": {}, "v": {}}}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = abstract
        for p in parents:
            node = node[p]
        node[name] = jax.ShapeDtypeStruct(
            () if isinstance(leaf, int) else tuple(leaf.shape),
            jnp.int32 if isinstance(leaf, int) else
            {torch.bfloat16: jnp.bfloat16,
             torch.float32: jnp.float32}[leaf.dtype])
    restored, _ = jck.restore(str(tmp_path / "port"), 1, abstract)
    for path, leaf in flat.items():
        node = restored
        for p in path.split("/"):
            node = node[p]
        want = np.array(leaf) if isinstance(leaf, int) else \
            leaf.detach().float().numpy()
        np.testing.assert_array_equal(np.asarray(node, np.float32), want,
                                      err_msg=path)


def test_restart_is_bitwise(tmp_path):
    """2N steps straight == N steps, save, restore into fresh objects, N
    more: every parameter and optimizer leaf bit for bit."""
    n = 3
    straight, s_state, _, _ = _trained(2 * n)
    model, state, step, pipe = _trained(n)
    ck.save(str(tmp_path), n, {"params": model, "opt": state})
    m2, st2 = _fresh()
    ck.restore(str(tmp_path), n, {"params": m2, "opt": st2})
    for s in range(n, 2 * n):
        step(m2, st2, device_put_batch(pipe.get_batch(s), "cpu"))
    _assert_bitwise({"params": straight, "opt": s_state},
                    {"params": m2, "opt": st2})


def test_restart_replays_data_stream():
    b5 = SyntheticLMPipeline(4, 32, seed=3).get_batch(5)
    again = SyntheticLMPipeline(4, 32, seed=3)       # a restarted process
    np.testing.assert_array_equal(b5["tokens"], again.get_batch(5)["tokens"])


def test_train_cli_resumes_bitwise(tmp_path, monkeypatch, capsys):
    """``launch/train.py main()``: a run of 6 steps checkpointing every 3,
    and the same run cut after its step-3 checkpoint (its later files
    removed, as a crash leaves them) then resumed, end in bitwise-equal
    step_6 checkpoints.  The smoke configs' vocabulary (128) does not
    cover the fact world's tokens, so the CLI's smoke config here takes
    vocabulary 512."""
    smoke = TC.get_smoke
    monkeypatch.setattr(LT.C, "get_smoke", lambda a: dataclasses.replace(
        smoke(a), vocab_size=512))
    args = ["--arch", "smollm-135m", "--smoke", "--steps", "6", "--batch",
            "4", "--seq", "32", "--ckpt-every", "3", "--ckpt-dir"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    LT.main(args + [a], device="cpu")
    LT.main(args + [b], device="cpu")
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] checkpoint @ 3" in out
    assert "[train] done: final loss" in out
    shutil.rmtree(os.path.join(b, "step_6"))
    with open(os.path.join(b, "LATEST"), "w") as f:
        f.write("3")
    LT.main(args + [b, "--resume"], device="cpu")
    assert "[train] resumed from step 3" in capsys.readouterr().out
    la, ea = ck.load_leaves(a, 6)
    lb, eb = ck.load_leaves(b, 6)
    assert ea == eb == {"step": 6} and sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(_bits(la[k]), _bits(lb[k]), err_msg=k)

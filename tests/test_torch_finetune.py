"""The port's fine-tuning loop and CLI on the CPU, against the JAX package
where both compute the same thing:

- ``sample_patches`` equals JAX's on one y4m clip (the same numpy draws
  over the same decoded frames: equal arrays);
- ``python -m video_restore_tpu_torch.training.finetune CLIP --cpu --steps
  2`` end to end at the CLI's default model (RealESRGAN_x4plus_anime_6B at
  full width, random weights): finite losses, an ``.npz`` that both
  packages' zoos load;
- ``Trainer.fit_patches`` draws its batches as documented (indices, then
  the noise, from one ``torch.Generator(seed)``) and sends the patches to
  the device once;
- the checkpoint round trip (``torch.save`` / ``torch.load(weights_only)``);
- no fallback: without CUDA, ``Trainer`` without a device and the CLI
  without ``--cpu`` raise. (``mesh=`` and the sharded step run:
  ``tests/test_torch_train_sharded.py``.)
"""

import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models import zoo as port_zoo
from video_restore_tpu_torch.training import finetune, train
from video_restore_tpu_torch.video.y4m import Y4MWriter

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture
def clip(tmp_path):
    """A 5-frame 64x80 y4m clip with texture (no flat patches)."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:80]
    path = tmp_path / "clip.y4m"
    with Y4MWriter(path, 80, 64, 25) as w:
        for t in range(5):
            f = np.stack([xx * 3 + 7 * t, yy * 4, (xx + yy) * 2], -1) % 256
            w.write(np.clip(f + rng.integers(-20, 20, f.shape), 0, 255).astype(np.uint8))
    return path


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("patch,max_patches,seed", [(32, 8, 0), (24, 50, 3)])
def test_sample_patches_equal_jax(clip, patch, max_patches, seed):
    from video_restore_tpu.training.finetune import sample_patches as jax_sample

    got = finetune.sample_patches([str(clip)], patch, max_patches, 4, seed)
    ref = jax_sample([str(clip)], patch, max_patches, 4, seed)
    assert got.dtype == np.float32 and got.shape[1:] == (patch, patch, 3)
    assert np.array_equal(got, ref)


def test_finetune_cli_cpu_end_to_end(clip, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.chdir(tmp_path)  # the zoo's default models/ is empty here
    out = tmp_path / "ft" / "x.npz"
    rc = finetune.main([
        str(clip), "--cpu", "--steps", "2", "--patch-size", "32",
        "--max-patches", "4", "--out", str(out),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
    ])
    assert rc == 0 and out.exists()
    text = capsys.readouterr().out
    first, last = (float(v) for v in text.split("loss ")[1].split()[0:3:2])
    assert np.isfinite(first) and np.isfinite(last)
    name = "RealESRGAN_x4plus_anime_6B"  # the CLI's default
    # the port's zoo
    tuned = port_zoo.load_params_npz(name, out)
    random = port_zoo.random_model(name).jax_params()
    assert not np.array_equal(tuned["conv_last"]["w"], random["conv_last"]["w"])
    # the JAX zoo (its template is the full-width net)
    from video_restore_tpu.models.zoo import load_params_npz as jax_load

    import jax

    jp = jax_load(name, out)
    np.testing.assert_array_equal(np.asarray(jp["body"]["rdb2"]["conv5"]["w"]), tuned["body"]["rdb2"]["conv5"]["w"])
    assert len(jax.tree.leaves(jp)) == len(jax.tree.leaves(tuned))
    ck = train.restore_checkpoint(tmp_path / "ckpt")
    assert ck["step"] == 2 and torch.equal(ck["params"]["conv_last.w"], torch.from_numpy(tuned["conv_last"]["w"]))


def test_fit_patches_draws_as_documented(rng):
    spec = port_zoo.MODEL_ZOO["RealESRGAN_x4_v3"].spec
    import dataclasses

    small = dataclasses.replace(spec, num_feat=8, num_conv=2, scale=2)
    handle = port_zoo.ModelHandle("t", small, port_zoo._arch(small).init_params(small))
    hr = rng.random((5, 16, 16, 3)).astype(np.float32)
    tr = train.Trainer(handle.train_module("cpu"), 2, learning_rate=1e-3, device="cpu")
    params = tr.fit_patches(hr, steps=3, seed=11)
    assert len(tr.losses) == 3 and all(np.isfinite(tr.losses))
    # the same batches and steps by hand
    net = handle.train_module("cpu")
    step = train.make_train_step(net, train.adam(net.parameters(), 1e-3))
    gen = torch.Generator().manual_seed(11)
    patches = torch.from_numpy(hr)
    losses = []
    for _ in range(3):
        idx = torch.randint(0, 5, (5,), generator=gen)
        batch = patches[idx]
        losses.append(float(step(train.degrade_batch(batch, 2, generator=gen), batch)))
    assert losses == tr.losses
    for k, v in net.state_dict().items():
        assert torch.equal(params[k], v), k


def test_checkpoint_round_trip(tmp_path):
    handle = port_zoo.random_model("RealESRGAN_x4_v3")
    tr = train.Trainer(handle.train_module("cpu"), 4, device="cpu")
    hr = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    params = tr.fit_patches(hr, steps=1)
    train.save_checkpoint(tmp_path / "c", params, tr.opt_state, 7)
    got = train.restore_checkpoint(tmp_path / "c")
    assert got["step"] == 7 and got["params"].keys() == params.keys()
    for k, v in params.items():
        assert torch.equal(got["params"][k], v), k
    # the optimizer resumes from it
    opt = train.adam(handle.train_module("cpu").parameters(), 1e-4)
    opt.load_state_dict(got["opt_state"])
    assert opt.state_dict()["state"][0]["step"] == 1


def test_no_cpu_fallback_without_cuda(clip, tmp_path, monkeypatch):
    _no_cuda()
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    net = port_zoo.random_model("RealESRGAN_x4_v3").train_module("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer(net, 4)
    out = tmp_path / "x.npz"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main([str(clip), "--steps", "1", "--out", str(out)])
    assert not out.exists()

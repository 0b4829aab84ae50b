"""The port's sharded (dp, tp) train step against the JAX package's GSPMD
step on its virtual CPU devices, and against the port's one-device step,
on the CPU:

- ``_param_spec`` shards the same leaves along the same (output-channel)
  dimension as JAX's, the port's leaf names mapped through
  ``params_to_jax``: SRVGG and RRDBNet at nf 16 and at full width, tp 2
  and 4 (exact);
- 2 steps of ``train_step_sharded`` on dp x tp gloo processes
  (``tools/train_sharded.py``, ``--cpu``), for (dp, tp) = (2, 2) with SRVGG
  (nf 16, 4 convs) and RRDBNet (nf 16, 1 block, gc 8), and (2, 1), (1, 2)
  with SRVGG, against JAX ``train_step_sharded`` on a mesh of the same
  shape and against ``make_train_step`` on one device, from the same
  weights and batches, with ``test_torch_train.py``'s tolerances:
  losses within 1e-5 relative, step-1 gradients within 1e-4 of each leaf's
  largest (JAX's from ``jax.grad`` of the same loss), Adam's moments
  after step 1 within 1e-4 (``exp_avg``) and 2e-4 (``exp_avg_sq``) of each
  leaf's largest against the one-device optimizer's, weights within
  ``2 * steps * lr`` (a gradient within rounding of 0 may take Adam's step,
  +-lr whatever its size, the other way). The targets sit at least 0.05
  from the output, as in ``test_torch_train.py``;
- ``Trainer(mesh=)`` on a (2, 2) mesh of 4 gloo processes against
  ``Trainer()`` on one device (the same batches from the same seed): losses
  within 1e-5 relative, weights within ``2 * steps * lr``, Adam's moments
  held as each rank's slice.

Every subprocess has its own timeout.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_restore_tpu.models import zoo as jax_zoo
from video_restore_tpu.models.rrdbnet import RRDBNetSpec, init_rrdbnet
from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
from video_restore_tpu.training import losses as jax_losses
from video_restore_tpu_torch.models import rrdbnet as port_rrdbnet
from video_restore_tpu_torch.models import srvgg as port_srvgg
from video_restore_tpu_torch.models import zoo as port_zoo
from video_restore_tpu_torch.tools.train_sharded import make_job
from video_restore_tpu_torch.training import train as port_train

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180  # seconds per subprocess
STEPS, LR_RATE = 2, 1e-3

NETS = {
    "srvgg": SRVGGSpec(num_feat=16, num_conv=4, scale=4),
    "rrdb": RRDBNetSpec(num_feat=16, num_block=1, num_grow_ch=8, scale=4),
}


def _arch(spec):
    return port_rrdbnet if isinstance(spec, RRDBNetSpec) else port_srvgg


def _port_spec(spec):
    if isinstance(spec, RRDBNetSpec):
        return port_rrdbnet.RRDBNetSpec(num_feat=spec.num_feat, num_block=spec.num_block,
                                        num_grow_ch=spec.num_grow_ch, scale=spec.scale)
    return port_srvgg.SRVGGSpec(num_feat=spec.num_feat, num_conv=spec.num_conv, scale=spec.scale)


def _jax_params(spec, seed=0):
    """Seeded weights in the JAX tree (shapes from ``jax.eval_shape`` of
    the JAX init, values from numpy, so that no eager JAX init runs): convs
    normal with the JAX init's std (``sqrt(2 / fan_in) * 0.1``), the SRVGG
    ones x10 (Kaiming: the x0.1 leaves the net close to its
    nearest-upsampled input), PReLU alphas 0.25, every leaf plus N(0, 0.02)
    (as ``test_torch_train.py``'s perturbed init)."""
    rrdb = isinstance(spec, RRDBNetSpec)
    init = init_rrdbnet if rrdb else init_srvgg
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 4:
            base = rng.normal(0, (2.0 / (9 * s.shape[-2])) ** 0.5 * (0.1 if rrdb else 1.0), s.shape)
        else:
            base = np.full(s.shape, 0.25 if "alpha" in jax.tree_util.keystr(path) else 0.0)
        return (base + rng.normal(0, 0.02, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(argv_fn, n, cwd):
    """Start n ranks (``argv_fn(rank, coordinator)``), each waited for at
    most TIMEOUT seconds; fails with the output of a rank that failed or
    hung."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(argv_fn(r, coord), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              cwd=cwd, env=env, text=True) for r in range(n)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"rank hung:\n{out[-3000:]}")
        assert p.returncode == 0, out[-3000:]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# _param_spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["srvgg", "rrdb", "RealESRGAN_x4_v3", "RealESRGAN_x4plus"])
@pytest.mark.parametrize("tp", [2, 4])
def test_param_spec_shards_the_leaves_jax_shards(name, tp):
    from video_restore_tpu.training.train import _param_spec

    if name in NETS:
        spec = NETS[name]
        pspec = _port_spec(spec)
    else:
        spec = jax_zoo.MODEL_ZOO[name].spec
        pspec = port_zoo.MODEL_ZOO[name].spec
    init = init_rrdbnet if isinstance(spec, RRDBNetSpec) else init_srvgg
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), spec))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        sp = tuple(_param_spec(leaf, tp))
        want[jax.tree_util.keystr(path)] = (leaf.shape, sp.index("tp") if "tp" in sp else None)
    arch = _arch(spec)
    net = (port_rrdbnet.RRDBNet if arch is port_rrdbnet else port_srvgg.SRVGGNet)(pspec)
    sd = net.state_dict()
    dims = {k: port_train._param_spec(v, tp) for k, v in sd.items()}
    assert all(d in (None, sd[k].dim() - 1) for k, d in dims.items())
    # each leaf marked 1 where sharded, through the converter (which stacks
    # the body on a new leading axis: the last dimension stays the last)
    marks = arch.params_to_jax({k: torch.full(v.shape, float(dims[k] is not None)) for k, v in sd.items()})
    got = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(marks)[0]:
        (flag,) = np.unique(leaf)
        got[jax.tree_util.keystr(path)] = (leaf.shape, leaf.ndim - 1 if flag else None)
    assert got == want
    assert any(v[1] is not None for v in got.values())


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def _batches(jm, spec, rng):
    """STEPS batches of 4 LR patches of 8x8 with targets at least 0.05 from
    the JAX output at the initial weights, on either side."""
    fn = jm.apply_fn(differentiable=True)
    out = []
    for _ in range(STEPS):
        lr = rng.random((4, 8, 8, 3)).astype(np.float32)
        y = np.asarray(fn(jm.params, jnp.asarray(lr)))
        gap = (0.05 + 0.2 * rng.random(y.shape)) * rng.choice([-1.0, 1.0], y.shape)
        out.append((lr, (y + gap).astype(np.float32)))
    return out


@pytest.mark.parametrize("name,dp,tp", [("srvgg", 2, 2), ("rrdb", 2, 2), ("srvgg", 2, 1), ("srvgg", 1, 2)])
def test_sharded_step_matches_jax_and_one_device(tmp_path, name, dp, tp):
    from jax.sharding import Mesh

    from video_restore_tpu.training.train import train_step_sharded

    spec = NETS[name]
    params = _jax_params(spec, seed=3)
    jm = jax_zoo.ModelHandle(name, spec, jax.tree.map(jnp.asarray, params))
    batches = _batches(jm, spec, np.random.default_rng(7))
    fn = jm.apply_fn(differentiable=True)

    lr0, hr0 = (jnp.asarray(a) for a in batches[0])
    jgrads = _flat(jax.grad(lambda p: jax_losses.charbonnier_loss(fn(p, lr0), hr0))(jm.params))
    # JAX: GSPMD over a (dp, tp) mesh of virtual CPU devices (the step
    # donates its state: it gets a copy of the weights)
    mesh = Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))
    tx = optax.adam(LR_RATE)
    start = jax.tree.map(jnp.array, params)
    with mesh:
        step, jparams, opt_state = train_step_sharded(fn, tx, mesh, start, tx.init(start))
        jax_losses_ = []
        for lr, hr in batches:
            jparams, opt_state, loss = step(jparams, opt_state, jnp.asarray(lr), jnp.asarray(hr))
            jax_losses_.append(float(loss))
    jfinal = _flat(jparams)

    # the port: dp x tp gloo ranks on the CPU
    arch = _arch(spec)
    state = arch.params_from_jax(params)
    job = make_job(_port_spec(spec), state, LR_RATE,
                   [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in batches])
    torch.save(job, tmp_path / "job.pt")
    _ranks(lambda r, coord: [
        sys.executable, "-m", "video_restore_tpu_torch.tools.train_sharded", "--dp", str(dp),
        "--tp", str(tp), "--job", str(tmp_path / "job.pt"), "--cpu", "--coordinator", coord,
        "--world-size", str(dp * tp), "--rank", str(r), "--out", str(tmp_path / "res.pt"),
    ], dp * tp, tmp_path)
    res = torch.load(tmp_path / "res.pt", weights_only=True)
    assert res["backend"] == "gloo"
    assert any(d is not None for d in res["shardings"].values())

    # the port on one device
    net = port_zoo.ModelHandle(name, _port_spec(spec), state).train_module("cpu")
    opt = port_train.adam(net.parameters(), LR_RATE)
    one = port_train.make_train_step(net, opt)
    one_losses = []
    for i, (lr, hr) in enumerate(batches):
        one_losses.append(float(one(torch.from_numpy(lr), torch.from_numpy(hr))))
        if i == 0:
            one_grads = {k: p.grad.clone() for k, p in net.named_parameters()}
            one_moments = {m: {k: opt.state[p][m].clone() for k, p in net.named_parameters()}
                           for m in ("exp_avg", "exp_avg_sq")}

    np.testing.assert_allclose(res["losses"], jax_losses_, rtol=1e-5)
    np.testing.assert_allclose(res["losses"], one_losses, rtol=1e-5)
    got_grads = _flat(arch.params_to_jax(res["grads"]))
    assert got_grads.keys() == jgrads.keys()
    for k, g in got_grads.items():
        scale = np.abs(jgrads[k]).max()
        assert scale > 0 and np.abs(g - jgrads[k]).max() <= 1e-4 * scale, k
    for k, g in res["grads"].items():
        assert (g - one_grads[k]).abs().max() <= 1e-4 * one_grads[k].abs().max(), k
    # Adam's moments after step 1, each rank's slices gathered: 0.1 g and
    # 0.001 g^2, so within 1e-4 and 2e-4 of each leaf's largest
    for m, tol in (("exp_avg", 1e-4), ("exp_avg_sq", 2e-4)):
        assert res["moments"][m].keys() == one_moments[m].keys()
        for k, v in res["moments"][m].items():
            assert (v - one_moments[m][k]).abs().max() <= tol * one_moments[m][k].abs().max(), (m, k)
    got_final = _flat(arch.params_to_jax(res["state"]))
    for k, w in got_final.items():
        assert np.abs(w - jfinal[k]).max() <= 2 * STEPS * LR_RATE, k
    for k, w in res["state"].items():
        assert (w - net.state_dict()[k]).abs().max() <= 2 * STEPS * LR_RATE, k


_TRAINER = r"""
import sys, torch
from video_restore_tpu_torch.models.zoo import ModelHandle
from video_restore_tpu_torch.models.srvgg import SRVGGSpec
from video_restore_tpu_torch.parallel.mesh import train_mesh
from video_restore_tpu_torch.parallel.multihost import init_multihost
from video_restore_tpu_torch.training.train import Trainer

torch.set_num_threads(1)
coord, rank, job, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_multihost(coord, 4, rank)
j = torch.load(job, weights_only=True)
net = ModelHandle("t", SRVGGSpec(**j["spec"]), j["state"]).train_module("cpu")
tr = Trainer(net, 4, learning_rate=j["lr_rate"], mesh=train_mesh(2, 2, "cpu"), device="cpu")
tr.fit_patches(j["patches"].numpy(), steps=2, seed=0)
params = tr.params
for p in tr.model.parameters():
    st = tr.optimizer.state[p]
    assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
if rank == 0:
    torch.save({"losses": tr.losses, "params": params,
                "sliced": [tuple(p.shape) for p in tr.model.parameters()]}, out)
torch.distributed.destroy_process_group()
"""


def test_trainer_with_a_mesh_matches_one_device(tmp_path):
    spec = NETS["srvgg"]
    state = port_srvgg.params_from_jax(_jax_params(spec, seed=5))
    patches = torch.from_numpy(np.random.default_rng(9).random((6, 32, 32, 3)).astype(np.float32))
    torch.save({"spec": {"num_feat": 16, "num_conv": 4, "scale": 4}, "state": state,
                "lr_rate": LR_RATE, "patches": patches}, tmp_path / "job.pt")
    _ranks(lambda r, coord: [sys.executable, "-c", _TRAINER, coord, str(r), str(tmp_path / "job.pt"),
                             str(tmp_path / "res.pt")], 4, tmp_path)
    res = torch.load(tmp_path / "res.pt", weights_only=True)
    net = port_zoo.ModelHandle("t", _port_spec(spec), state).train_module("cpu")
    one = port_train.Trainer(net, 4, learning_rate=LR_RATE, device="cpu")
    one.fit_patches(patches.numpy(), steps=2, seed=0)
    np.testing.assert_allclose(res["losses"], one.losses, rtol=1e-5)
    assert res["params"].keys() == one.params.keys()
    for k, v in one.params.items():
        assert res["params"][k].shape == v.shape
        assert (res["params"][k] - v).abs().max() <= 2 * 2 * LR_RATE, k
    # the ranks held slices: the body's output channels halved
    assert (4, 3, 3, 16, 8) in res["sliced"]

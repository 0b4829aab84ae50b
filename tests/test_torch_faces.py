"""The port's face pass (``video_restore_tpu_torch/ops/faces.py`` on
``ops/resample.py``) against the JAX package's ``ops/faces.py``, on the
CPU, where the JAX functions call OpenCV.

- The geometry under the pass, each against the ``cv2`` call it replaces:
  ``warp_affine`` (u8 with a border value: within 1 level, at most 0.1% of
  values differ; float32: 4e-3 on values up to ~80), ``invert_affine``
  (1e-6 relative: cv2 rounds some steps to float32), ``bilateral_u8`` (within 1 level, at most 0.1%),
  ``gaussian_blur`` (1e-4 on 0..255), the YCrCb conversion (equal) and the
  connected components (equal stats in cv2's label order).
- ``FaceBox`` and ``_feather_mask``: equal.
- The skin detector: the same boxes in the same order as JAX's
  ``_detect_skin_regions`` on frames with several blobs, a blob over the
  frame edge, a sparse blob, a blob too small and one too long, and two
  blobs whose label order differs between a pixel and a 2x2-block raster;
  ``detect_faces`` equal to JAX's through the detector both pick here, and
  the skin detector when OpenCV is missing.
- ``enhance_face_regions``: within 1 level of JAX's, byte-equal outside the
  expanded boxes.
- ``align_transform``: within 1e-4 of ``cv2.estimateAffinePartial2D(LMEDS)``
  on exact similarity landmarks, within 1e-3 with 0.5 px of noise; both
  refuse degenerate landmarks.
- ``restore_faces_learned`` with the same deterministic stub restorer, on
  aligned, square and mixed faces: within 1 level of JAX's, on at most
  0.5% of values (the bilinear warps round a few values the other way:
  7e-5 of them here), byte-equal outside the faces' windows; strength 0
  and no faces leave the frame.
- ``make_gfpgan_runner``: None without weights, as JAX's; its forwards of
  at most ``_MAX_CROPS`` crops equal one forward of all.
- ``VideoRestorer.process_video`` with ``face_enhance`` on a tiny SRVGG
  (``test_faces.py``'s), the heuristic and the prior (a stub runner in each
  package), against the JAX pipeline: within 1 level on at most 0.5% of
  values, as the other pipeline tests; the ``faces`` stage is timed; and
  "gfpgan" without weights fails as JAX's does.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu.ops import faces as jf
from video_restore_tpu_torch.ops import faces as pf
from video_restore_tpu_torch.ops import resample

cv2 = pytest.importorskip("cv2")

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

SKIN = (220, 170, 140)  # Y 182, Cr 155, Cb 104: inside the skin box


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([xx * 200 / w + 20, yy * 180 / h + 30, np.full((h, w), 90.0)], -1)
    return np.clip(f + rng.normal(0, 12, f.shape), 0, 255).astype(np.uint8)


def _blue(h, w, seed=0):
    """A bluish background no skin threshold takes (Cb > 130)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([40 + xx * 60 / w, 70 + yy * 50 / h, np.full((h, w), 170.0)], -1)
    return np.clip(f + rng.normal(0, 6, f.shape), 0, 255).astype(np.uint8)


def _u8_close(got, want, frac=0.001):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


# ---------------------------------------------------------------------------
# geometry against cv2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_affine_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    img = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    th, s = np.deg2rad(rng.uniform(-40, 40)), rng.uniform(0.4, 3.0)
    m = np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-40, 40)],
                  [s * np.sin(th), s * np.cos(th), rng.uniform(-40, 40)]], np.float32)
    want = cv2.warpAffine(img, m, (200, 150), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=(135, 133, 132))
    got = resample.warp_affine(torch.from_numpy(img), m, (200, 150), (135, 133, 132)).numpy()
    _u8_close(got, want)
    imgf = img.astype(np.float32) / 3.3
    want = cv2.warpAffine(imgf, m, (200, 150), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    got = resample.warp_affine(torch.from_numpy(imgf), m, (200, 150)).numpy()
    np.testing.assert_allclose(got, want, atol=4e-3)
    np.testing.assert_allclose(resample.invert_affine(m), cv2.invertAffineTransform(m), rtol=1e-6, atol=1e-5)
    # a window of dst is the full warp's, cropped
    win = resample.warp_affine(torch.from_numpy(imgf), m, (50, 40), origin=(30, 70)).numpy()
    np.testing.assert_array_equal(win, got[70:110, 30:80])


@pytest.mark.parametrize("blur", [0, 3])
def test_bilateral_and_gaussian_match_cv2(blur):
    img = _frame(53, 71, seed=4)
    if blur:
        img = cv2.GaussianBlur(img, (0, 0), blur)
    _u8_close(resample.bilateral_u8(torch.from_numpy(img), 7, 30, 30).numpy(),
              cv2.bilateralFilter(img, 7, 30, 30))
    f = img.astype(np.float32)
    np.testing.assert_allclose(resample.gaussian_blur(torch.from_numpy(f), 1.2).numpy(),
                               cv2.GaussianBlur(f, (0, 0), 1.2), atol=1e-4)


def test_ycrcb_and_components_match_cv2():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (512, 512, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pf._rgb_to_ycrcb_u8(px), cv2.cvtColor(px, cv2.COLOR_RGB2YCrCb))
    for t in range(20):
        m = (rng.random((40, 60)) < 0.08 + 0.01 * t).astype(np.uint8)
        n, _, st, _ = cv2.connectedComponentsWithStats(m)
        assert pf._components(m) == [tuple(int(v) for v in st[i]) for i in range(1, n)]
    # a pixel raster puts B (row 2) first, cv2's 2x2 blocks put A (row 3,
    # the same block row, further left) first
    m = np.zeros((10, 20), np.uint8)
    m[3, 2] = m[2, 10] = 1
    assert [s[:2] for s in pf._components(m)] == [(2, 3), (10, 2)]


# ---------------------------------------------------------------------------
# detection


@pytest.mark.parametrize("box", [(10, 20, 30, 40), (0, 0, 7, 9), (33, 5, 50, 21)])
def test_facebox_matches_jax(box):
    lm = tuple((1.5 * i, 2.25 * i) for i in range(5))
    for s in (1, 2, 4, 1.5):
        want = jf.FaceBox(*box, landmarks=lm).scaled(s)
        got = pf.FaceBox(*box, landmarks=lm).scaled(s)
        assert _fields(got) == _fields(want)
        for frac in (0.25, 0.5):
            assert _fields(got.expanded(frac, 100, 90)) == _fields(
                want.expanded(frac, 100, 90)
            )
    for h, w in ((512, 512), (37, 80), (3, 5)):
        np.testing.assert_array_equal(pf._feather_mask(h, w), jf._feather_mask(h, w))


def _fields(b):
    return (b.x, b.y, b.w, b.h, b.landmarks)


def _skin_frame(seed):
    """A 240x320 frame with skin blobs: two faces, one over the left edge,
    a sparse ring, a small blob, a long bar, and two blobs whose labels
    order differently by pixel and by 2x2 block."""
    f = _blue(240, 320, seed)
    yy, xx = np.mgrid[0:240, 0:320]
    rng = np.random.default_rng(seed)
    for cx, cy, rx, ry in ((80 + seed, 90, 22, 30), (-6, 160, 20, 28), (230, 60 + seed, 18, 24)):
        f[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] = SKIN
    ring = (np.hypot(xx - 250, yy - 180) <= 30) & (np.hypot(xx - 250, yy - 180) >= 25)
    f[ring] = SKIN  # sparse: area < 0.35 w h
    f[200:210, 20:30] = SKIN  # too small
    f[20:35, 120:220] = SKIN  # too long (aspect)
    f[115:150, 150:180] = SKIN  # starts on row 115 (block row 57) ...
    f[114:150, 195:225] = SKIN  # ... this one on row 114, the same block row
    return np.clip(f.astype(np.int32) + rng.integers(-3, 4, f.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skin_detector_matches_jax(seed):
    frame = _skin_frame(seed)
    want = jf._detect_skin_regions(frame, 24)
    got = pf._detect_skin_regions(frame, 24)
    assert [_fields(b) for b in got] == [_fields(b) for b in want]
    assert len(got) >= 4


def test_detector_chain_matches_jax(monkeypatch):
    """Both packages pick the same detector on the same machine (here the
    skin detector: this OpenCV has neither a YuNet model file nor the Haar
    cascade's XML) and find the same faces; without OpenCV the port takes
    the skin detector."""
    import sys

    from test_faces import _synthetic_face

    assert pf._init_detector()[0] == jf._init_detector()[0]
    for img in (_synthetic_face(200), _synthetic_face(320), _skin_frame(0)):
        want = jf.detect_faces(img)
        got = pf.detect_faces(img)
        assert [_fields(b) for b in got] == [_fields(b) for b in want]
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert pf._init_detector() == ("skin", None)
    monkeypatch.setattr(pf, "_detector", ("skin", None))
    frame = _skin_frame(1)
    assert pf.detect_faces(frame) == pf._detect_skin_regions(frame, 24)


# ---------------------------------------------------------------------------
# the heuristic and the learned path


def _outside(shape, boxes):
    keep = np.ones(shape[:2], bool)
    for x, y, w, h in boxes:
        keep[max(y, 0) : y + h, max(x, 0) : x + w] = False
    return keep


@pytest.mark.parametrize("strength", [0.5, 0.9])
def test_enhance_face_regions_matches_jax(strength):
    hr = _frame(200, 260, seed=7)
    boxes = [(10, 12, 30, 34), (100, 60, 28, 30), (0, 80, 20, 22), (108, 70, 20, 20)]
    want = jf.enhance_face_regions(hr, [jf.FaceBox(*b) for b in boxes], 2, strength)
    got = pf.enhance_face_regions(torch.from_numpy(hr), [pf.FaceBox(*b) for b in boxes], 2, strength)
    got = got.numpy()
    _u8_close(got, want, frac=0.01)
    exp = [_fields(pf.FaceBox(*b).scaled(2).expanded(0.25, 260, 200))[:4] for b in boxes]
    keep = _outside(hr.shape, exp)
    np.testing.assert_array_equal(got[keep], hr[keep])
    assert (got != hr).any()
    assert pf.enhance_face_regions(torch.from_numpy(hr), [], 2) is not None


def _similarity(theta_deg, s, t):
    th = np.deg2rad(theta_deg)
    rot = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return pf.FFHQ_TEMPLATE_512.astype(np.float64) @ rot.T + np.asarray(t)


@pytest.mark.parametrize("theta,s,noise", [(25.0, 0.35, 0.0), (-10.0, 1.7, 0.0), (25.0, 0.35, 0.5),
                                           (5.0, 0.8, 0.5)])
def test_align_transform_matches_jax(theta, s, noise):
    lm = _similarity(theta, s, (41.0, -13.0))
    lm = (lm + np.random.default_rng(1).normal(0, noise, lm.shape)).astype(np.float32)
    want = jf.align_transform(lm)
    got = pf.align_transform(lm)
    assert got.dtype == np.float32 and got.shape == (2, 3)
    tol = 1e-4 if noise == 0 else 1e-3
    # the linear part at its own scale, the shift in template pixels
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=tol * np.abs(want[:, :2]).max())
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=tol * 512)
    assert jf.align_transform(np.full((5, 2), 7.0, np.float32)) is None
    assert pf.align_transform(np.full((5, 2), 7.0, np.float32)) is None


def _stub(c):
    """A deterministic restorer: the same float32 arithmetic in numpy and
    torch (the crops' channels swapped, brightened and contrasted)."""
    return 1.0 - 0.8 * c[..., ::-1] if isinstance(c, np.ndarray) else 1.0 - 0.8 * c.flip(-1)


def _faces(kind):
    hr_w, hr_h = 640, 400
    lm_a = _similarity(20.0, 0.5, (300.0, 60.0))  # HR coordinates
    lm_b = _similarity(-15.0, 0.3, (470.0, 150.0))
    aligned = [dict(box=(140, 50, 60, 60), lm=lm_a / 2.0), dict(box=(230, 90, 40, 40), lm=lm_b / 2.0)]
    square = [dict(box=(20, 40, 40, 44)), dict(box=(280, 150, 30, 34)), dict(box=(2, 170, 30, 30))]
    chosen = {"aligned": aligned, "square": square, "mixed": [square[0], aligned[0], square[1]]}[kind]
    return (hr_h, hr_w), chosen


def _boxes(mod, faces):
    out = []
    for f in faces:
        lm = tuple(map(tuple, f["lm"].tolist())) if "lm" in f else None
        out.append(mod.FaceBox(*f["box"], landmarks=lm))
    return out


@pytest.mark.parametrize("kind", ["aligned", "square", "mixed"])
def test_restore_faces_learned_matches_jax(kind):
    (h, w), faces = _faces(kind)
    hr = _frame(h, w, seed=3)
    want = jf.restore_faces_learned(hr, _boxes(jf, faces), 2, _stub, 0.8)
    got = pf.restore_faces_learned(torch.from_numpy(hr), _boxes(pf, faces), 2, _stub, 0.8).numpy()
    _u8_close(got, want, frac=0.005)
    assert (want != hr).mean() > 0.01
    # outside every face's window the frame is untouched, as in JAX
    keep = want == hr
    np.testing.assert_array_equal(got[keep.all(-1)], hr[keep.all(-1)])
    same = pf.restore_faces_learned(torch.from_numpy(hr), _boxes(pf, faces), 2, _stub, 0.0)
    np.testing.assert_array_equal(same.numpy(), hr)


def test_restore_faces_learned_identity_cases():
    hr = torch.from_numpy(_frame(64, 64))
    boxes = [pf.FaceBox(4, 4, 10, 10)]
    assert pf.restore_faces_learned(hr, [], 2, _stub) is hr
    assert pf.restore_faces_learned(hr, boxes, 2, None) is hr
    # a square below 32 px is skipped, as in JAX
    assert pf.restore_faces_learned(hr, [pf.FaceBox(1, 1, 4, 4)], 2, _stub) is hr


def test_make_gfpgan_runner(tmp_path, monkeypatch):
    from video_restore_tpu_torch.models import gfpgan as pg

    monkeypatch.delenv("VRT_GFPGAN_RANDOM", raising=False)
    assert pf.make_gfpgan_runner(tmp_path) is None
    small = pg.GFPGANSpec(out_size=64)
    monkeypatch.setattr(pg, "load_gfpgan", lambda *a, **k: (pg.init_gfpgan(small), small))
    monkeypatch.setattr(pf, "_MAX_CROPS", 2)
    run = pf.make_gfpgan_runner(tmp_path)
    crops = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    net = pg.GFPGAN(small)
    net.load_state_dict(pg.init_gfpgan(small))
    with torch.no_grad():
        whole = net(crops.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(run(crops), whole, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the pipeline


def _tiny_models():
    """The same SRVGG (nf 8, 2 convs, x2) in both packages, its convs x10
    so that the output is not the upsampled input."""
    from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
    from video_restore_tpu.models.zoo import ModelHandle
    from video_restore_tpu_torch.models.srvgg import SRVGGSpec as PSpec
    from video_restore_tpu_torch.models.srvgg import params_from_jax
    from video_restore_tpu_torch.models.zoo import ModelHandle as PHandle

    spec = SRVGGSpec(num_feat=8, num_conv=2, scale=2)
    params = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(0), spec))
    for k in ("conv_in", "body", "conv_out"):
        params[k]["w"] = params[k]["w"] * 10.0
    return (ModelHandle("tiny", spec, jax.tree.map(jnp.asarray, params)),
            PHandle("tiny", PSpec(num_feat=8, num_conv=2, scale=2), params_from_jax(params)))


def _skin_clip(path, n=3):
    from video_restore_tpu.video import open_writer

    with open_writer(path, 64, 48, 25) as w:
        for t in range(n):
            f = _blue(48, 64, seed=t)
            yy, xx = np.mgrid[0:48, 0:64]
            if t != 1:  # frame 1 has no face
                f[((xx - 20 - 2 * t) / 13) ** 2 + ((yy - 22) / 15) ** 2 <= 1] = SKIN
            w.write(f)


@pytest.mark.parametrize("face_model", ["regions", "gfpgan"])
def test_process_video_with_faces_matches_jax(tmp_path, monkeypatch, face_model):
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.config import RestoreConfig as PConfig
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PRestorer

    # the skin detector in both packages, so that the tiny clip has faces
    monkeypatch.setattr(jf, "_detector", ("skin", None))
    monkeypatch.setattr(pf, "_detector", ("skin", None))
    if face_model == "gfpgan":
        monkeypatch.setattr(jf, "make_gfpgan_runner", lambda models_dir=None: _stub)
        monkeypatch.setattr(pf, "make_gfpgan_runner", lambda *a, **k: _stub)
    src = tmp_path / "in.npz"
    _skin_clip(src)
    cfg = dict(model_name="RealESRGAN_x4_v3", tile_size=16, tile_overlap=4, precision="fp32",
               audio_copy=False, face_enhance=True, face_model=face_model)
    jm, pm = _tiny_models()
    jr = VideoRestorer(RestoreConfig(**cfg), model=jm)
    pr = PRestorer(PConfig(**cfg), model=pm, cpu=True)
    outs = {}
    for tag, r in (("j", jr), ("p", pr)):
        assert r.process_video(src, tmp_path / f"out_{tag}.npz", show_progress=False)
        outs[tag] = np.load(tmp_path / f"out_{tag}.npz")["frames"]
    assert outs["p"].shape == outs["j"].shape == (3, 96, 128, 3)
    d = np.abs(outs["p"].astype(np.int32) - outs["j"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())
    assert "faces" in pr.last_stats.stages
    # the faces were found and restored: the output is not the plain step's
    plain = PRestorer(PConfig(**dict(cfg, face_enhance=False)), model=pm, cpu=True)
    assert plain.process_video(src, tmp_path / "plain.npz", show_progress=False)
    base = np.load(tmp_path / "plain.npz")["frames"]
    assert (outs["p"][0] != base[0]).any() and np.array_equal(outs["p"][1], base[1])


def test_gfpgan_without_weights_fails_as_jax(tmp_path, monkeypatch, caplog):
    from video_restore_tpu_torch.config import RestoreConfig as PConfig
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PRestorer

    monkeypatch.delenv("VRT_GFPGAN_RANDOM", raising=False)
    src = tmp_path / "in.npz"
    _skin_clip(src, n=1)
    _, pm = _tiny_models()
    cfg = PConfig(model_name="RealESRGAN_x4_v3", tile_size=16, tile_overlap=4, precision="fp32",
                  audio_copy=False, face_enhance=True, face_model="gfpgan",
                  models_dir=str(tmp_path / "models"))
    r = PRestorer(cfg, model=pm, cpu=True)
    assert not r.process_video(src, tmp_path / "out.npz", show_progress=False)
    assert "requires the GFPGANv1.4 weights" in caplog.text
    assert not (tmp_path / "out.npz").exists()

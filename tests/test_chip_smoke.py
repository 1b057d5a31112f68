"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases passes its gate at a small size (the phases run at full size
only on the GPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from uasl_motion_estimation_tpu.utils.synthetic import CameraRig

REPO = Path(__file__).resolve().parent.parent
TINY = CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                 height=96, width=160)
SMALL = dict(max_features=128, max_disparity=48)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_main_path_imports_without_cv2_or_matplotlib():
    """cv2 (utils/io.py) and matplotlib (utils/viz.py) stay lazy: the main
    path and chip_smoke import with both blocked."""
    code = (
        "import sys; sys.modules['cv2'] = None; "
        "sys.modules['matplotlib'] = None\n"
        "import chip_smoke\n"
        "from uasl_motion_estimation_tpu.models import (cross_modal, "
        "odometry, pipeline, smoother)\n"
        "from uasl_motion_estimation_tpu import parallel\n"
        "from uasl_motion_estimation_tpu.utils import checkpoint, synthetic\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_check_raises_on_failed_gate(capsys):
    cs.check("a", True, "x")
    with pytest.raises(cs.PhaseFailed):
        cs.check("b", False, "y")
    assert capsys.readouterr().out.splitlines() == ["[PASS] a: x",
                                                    "[FAIL] b: y"]


def test_phase_mi():
    assert cs.phase_mi(n_pairs=40) < cs.MI_ATOL


def test_mi_float64_reference():
    """The vectorized float64 reference against a per-pair histogram."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-10, 270, (6, 11, 11))
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255)
    got = cs.mi_float64(a, b)
    q = lambda x: np.clip(np.floor(x.ravel().astype(np.float32)
                                   * np.float32(20 / 256)), 0, 19).astype(int)
    for i in range(6):
        qa, qb = q(a[i]), q(b[i])
        joint = np.zeros((20, 20))
        np.add.at(joint, (qa, qb), 1 / 121)
        outer = joint.sum(1)[:, None] * joint.sum(0)[None, :]
        nz = joint > 0
        want = np.sum(joint[nz] * np.log2(joint[nz] / outer[nz]))
        assert abs(got[i] - want) < 1e-12


def test_phase_staged_and_streaming():
    w = cs.stereo_workload(TINY, 12, **SMALL)
    traj = cs.phase_staged(w, chunk=4)
    assert traj.shape == (12, 4, 4)
    assert cs.phase_streaming(w, traj, chunk=4) < cs.STREAM_ATOL_M


def test_phase_unified():
    res = cs.phase_unified(cs.stereo_workload(TINY, 12, corrupted=True,
                                              **SMALL))
    assert res.traj_ba.shape == (12, 4, 4)


def test_phase_latency_resume(tmp_path):
    w = cs.stereo_workload(TINY, cs.LATENCY_FRAMES, **SMALL)
    assert cs.phase_latency(w, tmp_path) < cs.LATENCY_ATOL_M


def test_phase_cross_modal():
    """The 192x320 cross-modal world of tests/test_scale.py."""
    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    w = cs.stereo_workload(rig, 8, seed=3, cross_modal=True,
                           max_features=256, max_disparity=64)
    assert len(cs.phase_cross_modal(w).scales) == 7


def test_four_card_phases_on_virtual_devices():
    """The --four phases on four of the test mesh's virtual CPU devices."""
    cs.run_four_cards(4, TINY, max_features=96, max_disparity=48)


@pytest.mark.gpu
def test_one_card_smoke_on_gpu(gpu):
    out = gpu("import chip_smoke; chip_smoke.main([])")
    last = json.loads(out.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"

"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases passes at tiny sizes (the card runs them at full size)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_exits_nonzero_without_gpu():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_phase_device_rejects_cpu():
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.phase_device()


def test_main_four_cards_fails_on_cpu(capsys):
    assert cs.main(["--four-cards"]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_station_phase_tiny():
    res = cs.phase_station(size=(128, 72), ticks=12, warmup=4,
                           oracle_ticks=2)
    assert res["ticks"] >= 16 and res["emitted"] == res["ticks"]
    assert res["egress_audio"] > 0 and res["egress_video"] > 0
    assert len(res["oracle_ticks"]) == 2
    assert res["compose_p50_ms"] > 0


def test_station_composition_geometry():
    comp = cs.station_composition((1920, 1080))
    els = {e.name: e.initial_state for e in comp.scenes[0].elements}
    assert els["full"].size == (1920.0, 1080.0)
    # pip1 at a non-integer 0.3 scale, overlapped by pip2, off knife edges
    w1, h1 = els["pip1"].size
    assert 1920 / w1 != round(1920 / w1)
    x1, y1 = els["pip1"].pic_pos
    x2, y2 = els["pip2"].pic_pos
    w2, h2 = els["pip2"].size
    assert x2 < x1 + w1 and x1 < x2 + w2 and y2 < y1 + h1 and y1 < y2 + h2
    for st in (els["pip1"], els["pip2"], els["pip3"]):
        assert st.pic_pos[0] % 1 == 0.25 and st.size[0] % 1 == 0.5


TINY = [
    (cs.check_tick_programs, dict(size=(256, 144))),
    (cs.check_rgba_convert, dict(src=(256, 144), out=(128, 72))),
    (cs.check_ladder, dict(src=(256, 144), rungs=((128, 72), (96, 54)))),
    (cs.check_resampler, dict(channels=4, n=4410)),
    (cs.check_audio_mix, dict(n=480, sources=3)),
    (cs.check_wall, dict(n=16, stream=(64, 36), canvas=(128, 72),
                         samples=48)),
    (cs.check_motion, dict(size=(192, 128), crop=(128, 64))),
]


def test_parity_checks_cover_the_card_list():
    assert [fn for fn, _ in TINY] == list(cs.PARITY_CHECKS)


@pytest.mark.parametrize("check,kwargs", TINY,
                         ids=[fn.__name__ for fn, _ in TINY])
def test_parity_check_tiny(check, kwargs):
    check(**kwargs)


@pytest.mark.parametrize("n,aligned", [(16, True), (10, False)])
def test_four_card_wall_on_virtual_devices(n, aligned):
    import jax
    cs.check_wall_mesh(jax.devices()[:4], n, stream=(64, 36),
                       canvas=(128, 72), samples=48, aligned=aligned)


def test_assert_lsb_rejects_two_lsb():
    a = [np.zeros((4, 4), np.uint8)]
    b = [np.full((4, 4), 2, np.uint8)]
    with pytest.raises(cs.SmokeError):
        cs.assert_lsb("two", a, b)
    cs.assert_lsb("one", a, [np.ones((4, 4), np.uint8)])

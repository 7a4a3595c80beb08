"""CLI surface tests.

Pins component N7 (the SE(2) frame calculator, ref
``rigid2d/src/main.cpp:5-101``) the way the reference pins its own
istream/ostream surface (``rigid2d/tests/tests.cpp:72-122``): a canonical
exchange piped through the subcommand, every printed transform / vector /
twist asserted against hand-derived values.

Fixture: T_ab = (90 deg, 0, 1), T_bc = (90 deg, 1, 0), so

    T_ba = (-90, -1, 0)   T_cb = (-90, 0, 1)
    T_ac = (180, 0, 2)    T_ca = (+-180, 0, 2)

vector (1, 1) in frame a:  v_b = (0, -1),  v_c = (-1, 1)
twist (1, 1, 1) in frame a: V_b = (1, 1, 0), V_c = (1, 1, -1)
"""

import io
import re

import numpy as np
import pytest

from shermbot_navigation.pipeline import cli

INPUT = "90 0 1\n90 1 0\n1 1\na\n1 1 1\na\n"


def _floats(line):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line)]


@pytest.fixture
def frames_output(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(INPUT))
    cli.main(["frames"])
    out = capsys.readouterr().out.strip().splitlines()
    return {line.split(":")[0]: _floats(line) for line in out}


def test_frames_transforms(frames_output):
    want = {
        "T_ab": (90.0, 0.0, 1.0),
        "T_ba": (-90.0, -1.0, 0.0),
        "T_bc": (90.0, 1.0, 0.0),
        "T_cb": (-90.0, 0.0, 1.0),
        "T_ac": (180.0, 0.0, 2.0),
        "T_ca": (180.0, 0.0, 2.0),
    }
    for name, (deg, dx, dy) in want.items():
        got = frames_output[name]
        if name in ("T_ac", "T_ca"):  # +-180 are the same rotation
            got = [abs(got[0]), got[1], got[2]]
        np.testing.assert_allclose(got, [deg, dx, dy], atol=1e-4,
                                   err_msg=name)


def test_frames_vector_in_all_frames(frames_output):
    np.testing.assert_allclose(frames_output["v_a"], [1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(frames_output["v_b"], [0.0, -1.0], atol=1e-5)
    np.testing.assert_allclose(frames_output["v_c"], [-1.0, 1.0], atol=1e-5)


def test_frames_twist_in_all_frames(frames_output):
    np.testing.assert_allclose(frames_output["V_a"], [1.0, 1.0, 1.0],
                               atol=1e-5)
    np.testing.assert_allclose(frames_output["V_b"], [1.0, 1.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(frames_output["V_c"], [1.0, 1.0, -1.0],
                               atol=1e-5)

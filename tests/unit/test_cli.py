"""CLI entry point (python -m image_stitch_tpu): thin argparse wrapper over
concat_to_file — a convenience beyond the reference, which ships library-only."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from utils.fixtures import decode_png_pil, png_from_array, random_rgba

from image_stitch_tpu.__main__ import main


@pytest.fixture()
def tile_files(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"tile{i}.png"
        p.write_bytes(png_from_array(random_rgba(48, 40, seed=i)))
        paths.append(str(p))
    return paths


def test_cli_grid_png(tile_files, tmp_path):
    out = tmp_path / "out.png"
    rc = main([*tile_files, "--columns", "2", "-o", str(out), "--quiet"])
    assert rc == 0
    arr = decode_png_pil(out.read_bytes())
    assert arr.shape == (80, 96, 4)
    np.testing.assert_array_equal(arr[:40, :48], random_rgba(48, 40, seed=0))


def test_cli_jpeg_by_extension(tile_files, tmp_path):
    out = tmp_path / "out.jpg"
    rc = main([*tile_files, "--columns", "4", "-o", str(out), "--quiet",
               "--quality", "95"])
    assert rc == 0
    data = out.read_bytes()
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_cli_positioned(tile_files, tmp_path):
    out = tmp_path / "pos.png"
    rc = main([tile_files[0], tile_files[1], "--positioned",
               "--at", "0,0", "--at", "20,10", "-o", str(out), "--quiet"])
    assert rc == 0
    arr = decode_png_pil(out.read_bytes())
    assert arr.shape == (50, 68, 4)


def test_cli_positioned_missing_at(tile_files, tmp_path, capsys):
    rc = main([tile_files[0], tile_files[1], "--positioned",
               "--at", "0,0", "-o", str(tmp_path / "x.png"), "--quiet"])
    assert rc == 2
    assert "--at" in capsys.readouterr().err


def test_cli_decode_error_is_clean(tmp_path, capsys):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"garbage" * 10)
    rc = main([str(bad), "-o", str(tmp_path / "o.png"), "--quiet"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_cli_threads_and_background(tile_files, tmp_path):
    out = tmp_path / "bg.png"
    rc = main([tile_files[0], tile_files[1], tile_files[2], "--columns", "2",
               "-o", str(out), "--threads", "3",
               "--background", "10,20,30,255", "--quiet"])
    assert rc == 0
    arr = decode_png_pil(out.read_bytes())
    # bottom-right cell is background
    np.testing.assert_array_equal(arr[79, 95], [10, 20, 30, 255])

"""Port parity on the CPU: the atlas queries, the ROI overlay, the HTML
viewer, cli.roi_visualize, and the p-values with cli.pvalue.

Every function runs beside the JAX package's on the same inputs in one
process: the queries and centroids are equal, the HTML page is the same
bytes, both CLIs print the same lines, and `compute_p_values` gives the
same numbers (the same scipy serves both here; scipy's Wilcoxon method
has changed across versions, so the comparison is made in one process
only), including the length-mismatch error and the all-zero-differences
case (W = 0, p = 1)."""

import json

import numpy as np
import pytest

from multimodal_ad_tpu.cli import pvalue as jax_pvalue_cli
from multimodal_ad_tpu.cli import roi_visualize as jax_roi_cli
from multimodal_ad_tpu.eval import atlas as jatlas
from multimodal_ad_tpu.eval import html_view as jhtml
from multimodal_ad_tpu.eval import stats as jstats
from multimodal_ad_tpu_torch.cli import pvalue as pvalue_cli
from multimodal_ad_tpu_torch.cli import roi_visualize as roi_cli
from multimodal_ad_tpu_torch.data.synthetic import make_atlas
from multimodal_ad_tpu_torch.eval import atlas, html_view, stats
from multimodal_ad_tpu_torch.utils import nifti
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

SHAPE = (12, 14, 10)


@pytest.fixture(scope="module")
def atlas_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("atlas")
    ids = np.array([0, 3, 7, 41, 42])
    labels = ids[make_atlas(SHAPE, n_rois=4, seed=1)].astype(np.int16)
    nii = str(root / "atlas.nii")
    nifti.save(nii, labels)
    lut = str(root / "atlas.json")
    with open(lut, "w") as f:  # id 7 left out: it is named ROI7
        json.dump({"rois": {"3": {"label": "Left"}, "41": {"label": "Hippocampus_L"},
                            "42": {"label": "Hippocampus_R"}}}, f)
    mri = str(root / "mri.nii")
    nifti.save(mri, np.random.default_rng(2).normal(size=SHAPE).astype(np.float32))
    return {"nii": nii, "lut": lut, "mri": mri, "root": root}


def _loaded(atlas_files):
    labels, roi_ids, names, affine = atlas.load_atlas(atlas_files["nii"], atlas_files["lut"])
    return labels, roi_ids, dict(zip((int(i) for i in roi_ids), names)), affine


def test_queries_match_jax(atlas_files):
    labels, roi_ids, names, affine = _loaded(atlas_files)
    for aff in (None, affine):
        ours, ref = atlas.roi_centers(labels, roi_ids, aff), jatlas.roi_centers(
            labels, roi_ids, aff)
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    for ijk in [(0, 0, 0), (6, 7, 5), (3, 9, 2), (11, 13, 9), (12, 0, 0), (-1, 2, 2)]:
        assert atlas.query_voxel(labels, names, ijk) == jatlas.query_voxel(labels, names, ijk)
    centers = atlas.roi_centers(labels, roi_ids, affine)
    for xyz in [(0.0, 0.0, 0.0), (10.5, -3.0, 7.25), (-40.0, 20.0, 1.0)]:
        assert atlas.query_world(xyz, centers, names) == jatlas.query_world(xyz, centers,
                                                                            names)


@pytest.mark.parametrize("case", ["volume_rois", "atlas_only", "no_labels"])
def test_html_bytes_equal_jax(atlas_files, tmp_path, case):
    labels, _, names, _ = _loaded(atlas_files)
    vol = nifti.load(atlas_files["mri"])
    kw = {"volume_rois": dict(labels=labels, roi_names_by_id=names, roi_ids=[41, 42],
                              title="ROI <overlay>"),
          "atlas_only": dict(labels=labels, roi_names_by_id=names),
          "no_labels": {}}[case]
    src = labels.astype(np.float32) if case == "atlas_only" else vol
    ours = html_view.save_interactive_html(src, str(tmp_path / "ours.html"), **kw)
    ref = jhtml.save_interactive_html(src, str(tmp_path / "ref.html"), **kw)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="3-D"):
        html_view.save_interactive_html(vol[0], str(tmp_path / "x.html"))


def test_overlay_writes_a_png(atlas_files, tmp_path):
    pytest.importorskip("matplotlib")
    labels, _, _, _ = _loaded(atlas_files)
    out = atlas.save_roi_overlay(nifti.load(atlas_files["mri"]), labels, [41, 42],
                                 str(tmp_path / "overlay.png"), axis=1)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case", ["queries_html", "mri_html", "mri_png"])
def test_roi_visualize_prints_what_jax_prints(atlas_files, tmp_path, capsys, case):
    if case == "mri_png":
        pytest.importorskip("matplotlib")
    base = ["--atlas", atlas_files["nii"], "--atlas-json", atlas_files["lut"]]

    def argv(tag):
        extra = {"queries_html": ["--query-voxel", "6", "7", "5", "--query-world",
                                  "-2", "-120", "-60", "--html", str(tmp_path / f"{tag}.html")],
                 "mri_html": ["--mri", atlas_files["mri"], "--all-rois",
                              "--html", str(tmp_path / f"{tag}.html")],
                 "mri_png": ["--mri", atlas_files["mri"], "--roi-ids", "3", "41",
                             "--out", str(tmp_path / f"{tag}.png")]}[case]
        return base + extra

    ours = _run(roi_cli.main, argv("port"), capsys)
    ref = _run(jax_roi_cli.main, argv("jax"), capsys)
    assert [line.replace("port", "jax") for line in ours] == ref
    assert len(ours) >= 1
    if case != "mri_png":
        with open(tmp_path / "port.html", "rb") as a, open(tmp_path / "jax.html", "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("a,b", [
    ([0.9152, 0.8830, 0.9218, 0.9340, 0.9418], [0.9867, 0.9767, 0.9806, 0.9845, 0.9751]),
    ([1, 2, 3], [1, 2, 3]),                      # all-zero differences (t is NaN)
    ([0.5, 0.6, 0.7, 0.8], [0.51, 0.58, 0.73, 0.8]),  # one zero difference
])
def test_p_values_match_jax(a, b, capsys):
    np.testing.assert_equal(stats.compute_p_values(a, b), jstats.compute_p_values(a, b))
    argv = ["--a", *map(str, a), "--b", *map(str, b)]
    assert _run(pvalue_cli.main, argv, capsys) == _run(jax_pvalue_cli.main, argv, capsys)


def test_p_values_identical_and_mismatched():
    assert stats.compute_p_values([1, 2, 3], [1, 2, 3])["wilcoxon_p"] == 1.0
    assert stats.compute_p_values([1, 2, 3], [1, 2, 3])["wilcoxon_stat"] == 0.0
    for mod in (stats, jstats):
        with pytest.raises(ValueError, match="equal length"):
            mod.compute_p_values([1, 2], [1, 2, 3])

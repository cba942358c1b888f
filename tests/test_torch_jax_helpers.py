"""Small public helpers of the JAX package and their ports.

``pipeline/seed_labels.py::is_valid_cluster`` (the per-cluster rule that
``filter_labels`` applies to every cluster at once),
``utils/config.py::log_config_to_file``, ``utils/visualize.py::plot_scene_3d``
(plotly imported lazily, None without it) and ``cli/train.py --ckpt``
(parsed, never read), each against the JAX package on the same inputs.
"""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest

from modest_tpu.cli import train as j_train_cli
from modest_tpu.pipeline import seed_labels as jsl
from modest_tpu.pipeline.ground_plane import estimate_plane as j_estimate_plane
from modest_tpu.utils import config as jconfig
from modest_tpu.utils import visualize as jvis
from modest_tpu_torch.cli import train as train_cli
from modest_tpu_torch.pipeline import seed_labels as tsl
from modest_tpu_torch.pipeline.ground_plane import estimate_plane
from modest_tpu_torch.utils import config as tconfig
from modest_tpu_torch.utils import visualize as tvis
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml"
RULE = dict(max_min_height=1.0, min_max_height=0.5, percentile=20, min_percentile_pp_score=0.7)


def _clusters():
    """tests/test_seed_labels.py::test_is_valid_cluster_filters's cases:
    (points, PP scores, keyword overrides, valid)."""
    grounded = np.stack([np.zeros(50), np.zeros(50), np.linspace(-1.7, 0.0, 50)], 1)
    low_pp = np.full(50, 0.1)
    flat = grounded.copy()
    flat[:, 2] = -1.75
    return {
        "grounded": (grounded, low_pp, {}, True),
        "floating": (grounded + [0, 0, 2.0], low_pp, {}, False),
        "flat": (flat, low_pp, {}, False),
        "persistent": (grounded, np.full(50, 0.9), {}, False),
        "too_few": (grounded[:5], low_pp[:5], {"min_points": 10}, False),
    }


@pytest.mark.parametrize("case", list(_clusters()))
def test_is_valid_cluster_equals_jax(case):
    ptc, pp, extra, valid = _clusters()[case]
    plane = np.array([0.0, 0.0, 1.0, 1.8])
    got = tsl.is_valid_cluster(ptc, pp, plane, **RULE, **extra)
    assert got == jsl.is_valid_cluster(ptc, pp, plane, **RULE, **extra) == valid


def test_filter_labels_equals_the_cluster_loop():
    """The port's filter_labels against a loop of its is_valid_cluster, and
    both against JAX's (tests/test_seed_labels.py's frame)."""
    rng = np.random.RandomState(3)
    n = 4000
    ptc = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                    rng.uniform(-1.9, 1.0, n), np.zeros(n)], 1).astype(np.float32)
    ptc[:2000, 2] = rng.normal(-1.8, 0.02, 2000)
    pp = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.randint(-1, 25, n).astype(np.int64)
    labels[rng.rand(n) < 0.3] = -1
    labels[labels == 7] = -1
    labels[np.where(labels == 9)[0][5:]] = -1
    kwargs = dict(min_points=10, max_volume=40, min_volume=0.5, max_min_height=1.0,
                  min_max_height=0.2, percentile=20, min_percentile_pp_score=0.7)

    plane = estimate_plane(ptc, max_hs=-1.5, ptc_range=((-70, 70), (-50, 50)))
    np.testing.assert_array_equal(
        plane, j_estimate_plane(ptc, max_hs=-1.5, ptc_range=((-70, 70), (-50, 50))))
    ref = labels.copy()
    verdicts = []
    for i in range(ref.max() + 1):
        sel = ref == i
        ok = tsl.is_valid_cluster(ptc[sel, :3], pp[sel], plane, **kwargs)
        assert ok == jsl.is_valid_cluster(ptc[sel, :3], pp[sel], plane, **kwargs)
        verdicts.append(ok)
        if not ok:
            ref[sel] = -1
    assert any(verdicts) and not all(verdicts)
    ref = np.searchsorted(np.unique(ref), ref)
    np.testing.assert_array_equal(tsl.filter_labels(ptc, pp, labels, **kwargs), ref)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(log_config_to_file, cfg, name):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(logging.INFO)
    handler = _Lines()
    logger.addHandler(handler)
    try:
        log_config_to_file(cfg, logger=logger)
    finally:
        logger.removeHandler(handler)
    return handler.lines


def test_log_config_to_file_lines_equal_jax():
    """The flagship config (the port's shipped dict, JAX's YAML) and a
    nested mapping with lists, None, floats and strings: the same lines."""
    nested = {"A": 1, "B": {"C": [1, 2.5, "x"], "D": None, "E": {"F": "y", "G": [{"H": 3}]}},
              "I": 1e-4, "J": True}
    for got_cfg, want_cfg in (
            (train_cli.load_model_config(REPO / FLAGSHIP),
             jconfig.cfg_from_yaml_file(REPO / FLAGSHIP)),
            (tconfig.Config(nested), jconfig.Config(nested))):
        got = _logged(tconfig.log_config_to_file, got_cfg, "torch_cfg_lines")
        want = _logged(jconfig.log_config_to_file, want_cfg, "jax_cfg_lines")
        assert got == want and len(got) > 5
    assert "----------- E -----------" in got and "cfg.B.E.F: y" in got


def test_log_config_to_file_prints_without_a_logger(capsys):
    tconfig.log_config_to_file(tconfig.Config({"A": {"B": 2}}), pre="x")
    assert capsys.readouterr().out.splitlines() == ["----------- A -----------", "x.A.B: 2"]


def test_plot_scene_3d_is_none_without_plotly(monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)
    pts = np.random.RandomState(0).randn(100, 4).astype(np.float32)
    boxes = np.array([[0, 0, 0, 4, 2, 1.5, 0.3]], np.float32)
    assert tvis.plot_scene_3d(pts, boxes) is None
    assert jvis.plot_scene_3d(pts, boxes) is None


def test_train_cli_parses_ckpt_as_jax_does():
    argv = ["--cfg_file", str(REPO / FLAGSHIP), "--ckpt", "output/x/ckpt/checkpoint_epoch_3.pth",
            "--epochs", "2"]
    args, cfg = train_cli.parse_config(argv)
    j_args, j_cfg = j_train_cli.parse_config(argv)
    assert args.ckpt == j_args.ckpt == "output/x/ckpt/checkpoint_epoch_3.pth"
    assert args.epochs == j_args.epochs == 2
    assert train_cli.parse_config(argv[:2])[0].ckpt is None

"""The port's pipeline CLIs vs the JAX CLIs on the synthetic mini-dataset of
tests/test_pipeline_cli.py: pre_compute_pp_score → generate_mask with
``device=cpu`` must write the same PP scores (to 1e-5; the JAX CPU route
counts with the approximate ``|x|²+|y|²−2x·y`` expansion), the same labels
and the same boxes.
"""
import pickle
import shutil

import numpy as np
import pytest
import torch

from modest_tpu.cli import generate_mask as j_generate_mask
from modest_tpu.cli import pre_compute_pp_score as j_pre_compute_pp_score
from modest_tpu_torch.cli import generate_mask, pre_compute_pp_score
from modest_tpu_torch.tools.pipeline_scenes import write_dataset

PP_DIR = "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
SEG_DIR = "intermediate_results/lyft_seg_pp_score_fw70_2m_r0.3"
BBOX_DIR = "intermediate_results/lyft_bbox_pp_score_fw70_2m_r0.3"


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """tests/test_pipeline_cli.py's scene: ground + wall (persistent) and a
    car only in sequence 0; three single-frame traversals."""
    rng = np.random.RandomState(42)
    ground = np.stack([rng.uniform(0, 60, 5000), rng.uniform(-20, 20, 5000),
                       rng.normal(-1.8, 0.01, 5000)], 1)
    wall = np.stack([rng.uniform(30, 34, 600), np.full(600, -10.0), rng.uniform(-1.8, 1.2, 600)], 1)
    car = rng.uniform(0, 1, (500, 3)) * [4.2, 1.8, 1.5] + [20.0, 3.0, -1.79]
    frames = {}
    for gid, seq in [(0, 0), (1, 1), (2, 2)]:
        static = np.concatenate([ground, wall]) + rng.randn(5600, 3) * 0.01
        frames[gid] = np.concatenate([static, car]) if seq == 0 else static
    root = tmp_path_factory.mktemp("lyftmini")
    write_dataset(root / "jax", frames, [[0], [1], [2]], {0: (0, 0, [(0, [0]), (1, [0]), (2, [0])])})
    shutil.copytree(root / "jax", root / "torch")
    return root


def _overrides(root, *extra):
    return [f"work_dir={root}", f"data_root={root / 'training'}", *extra]


def _outputs(root):
    seg = np.load(root / SEG_DIR / "000000.npy")
    with open(root / BBOX_DIR / "000000.pkl", "rb") as f:
        return seg, pickle.load(f)


def _assert_same_boxes(objs, j_objs):
    assert len(objs) == len(j_objs) == 1  # exactly the car
    for o, jo in zip(objs, j_objs):
        np.testing.assert_allclose(o.t, jo.t, atol=1e-4)
        np.testing.assert_allclose([o.l, o.w, o.h, o.ry, o.volume],
                                   [jo.l, jo.w, jo.h, jo.ry, jo.volume], atol=1e-4)


def _boundary_points(root, shell):
    """Origin points with a neighbour whose d² lies within ``shell`` m² of
    r² in some traversal (float64), where two exact-enough counts may differ."""
    from scipy.spatial import cKDTree

    from modest_tpu_torch.pipeline.pp_score import TraversalIndex

    with open(root / "meta_data/lyft/fw70_2m_train_track_list.pkl", "rb") as f:
        track_list = pickle.load(f)
    with open(root / "meta_data/lyft/fw70_2m_valid_train_idx_info.pkl", "rb") as f:
        valid_idx = pickle.load(f)
    index = TraversalIndex(root / "training", track_list, valid_idx)
    combined, trans_mat = index.combined_traversals(0)
    q = index.origin_cloud(0)[:, :3].astype(np.float64) @ trans_mat[:3, :3].T + trans_mat[:3, 3]
    out = np.zeros(len(q), bool)
    for cloud in combined.values():
        tree = cKDTree(cloud.astype(np.float64))
        out |= (tree.query_ball_point(q, r=np.sqrt(0.09 + shell), return_length=True)
                != tree.query_ball_point(q, r=np.sqrt(0.09 - shell), return_length=True))
    return out


def test_port_clis_write_what_the_jax_clis_write(mini):
    jax_root, root, root2 = mini / "jax", mini / "torch", mini / "torch_on_jax_pp"
    shutil.copytree(root, root2)
    j_pre_compute_pp_score.main(_overrides(jax_root))
    j_generate_mask.main(_overrides(jax_root, "graph.n_neighbors=30"))
    j_pp = np.load(jax_root / PP_DIR / "000000.npy")
    j_seg, j_objs = _outputs(jax_root)

    pre_compute_pp_score.main(_overrides(root, "device=cpu"))
    pp = np.load(root / PP_DIR / "000000.npy")
    assert pp.dtype == np.float32 and pp.shape == j_pp.shape == (6100,)
    assert pp[-500:].mean() < 0.2 and pp[:5000].mean() > 0.8  # car ephemeral, ground persistent
    # the JAX CLI counts on the CPU with the |x|²+|y|²−2x·y expansion, off by
    # up to ~1e-3 m² near the radius; the port counts exactly
    near = _boundary_points(root, 2e-3)
    np.testing.assert_allclose(pp[~near], j_pp[~near], rtol=0, atol=1e-6)
    assert (np.abs(pp - j_pp) > 1e-6).mean() < 0.01

    # seed masks and boxes from the JAX CLI's PP scores: equal
    shutil.copytree(jax_root / PP_DIR, root2 / PP_DIR)
    generate_mask.main(_overrides(root2, "graph.n_neighbors=30", "device=cpu"))
    seg, objs = _outputs(root2)
    np.testing.assert_array_equal(seg, j_seg)
    _assert_same_boxes(objs, j_objs)
    assert (root2 / SEG_DIR / "configs.yaml").exists()

    # and from the port's own PP scores: the same car
    generate_mask.main(_overrides(root, "graph.n_neighbors=30", "device=cpu"))
    seg, objs = _outputs(root)
    assert (seg == j_seg).mean() > 0.99
    _assert_same_boxes(objs, j_objs)

    # idempotent: a second run skips the existing outputs
    stamp = (root / PP_DIR / "000000.npy").stat().st_mtime_ns
    pre_compute_pp_score.main(_overrides(root, "device=cpu"))
    assert (root / PP_DIR / "000000.npy").stat().st_mtime_ns == stamp


def test_clis_run_on_the_card_unless_asked_for_the_cpu(mini):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    ov = [f"work_dir={mini / 'torch'}", f"data_root={mini / 'torch' / 'training'}"]
    for main in (pre_compute_pp_score.main, generate_mask.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(ov)

"""Configs as Python dicts, so a run needs no YAML parser.

``POINTRCNN_DYNAMIC_OBJ`` is the ``MODEL`` section of
``configs/models/lyft_models/pointrcnn_dynamic_obj.yaml`` (the flagship
detector, 12288-point Lyft scans); ``POINTRCNN_DYNAMIC_OBJ_FULL`` is the
whole file (``CLASS_NAMES``, ``DATA_CONFIG`` with its ``_BASE_CONFIG_``
``configs/datasets/lyft_dataset_dynamic_obj.yaml`` merged in, ``MODEL``,
``OPTIMIZATION``), which ``cli/train.py`` takes when ``--cfg_file`` names
that file. ``POINTPILLAR_DYNAMIC_OBJ(_FULL)``, ``SECOND_DYNAMIC_OBJ(_FULL)`` and
``PV_RCNN_DYNAMIC_OBJ(_FULL)`` are the grid detectors' and PV-RCNN's files
of the same directory, in the same forms, as are
``{SECOND_IOU,VOXEL_RCNN,PART_A2}_DYNAMIC_OBJ(_FULL)``;
``NUSCENES_BOSTON_POINTRCNN_DYNAMIC_OBJ_FULL`` is
``configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml`` whole.
``KITTI_<NAME>`` is the ``MODEL`` section of
``configs/models/kitti_models/<name>.yaml`` (``KITTI_CONFIGS`` the twelve whole
files, CaDDN's two among them), ``CBGS_{SECOND,PP}_MULTIHEAD`` the ``MODEL`` sections of
``configs/models/nuscenes_models/cbgs_{second,pp}_multihead.yaml`` (``CBGS_CONFIGS``
the two whole files) and ``WAYMO_CONFIGS`` the three files of
``configs/models/waymo_models/`` whole, each on its dataset base
(``NUSCENES_DATASET_BASE``, ``WAYMO_DATASET_BASE``). ``PIPELINE_*`` are
``configs/pipeline/{pp_score,generate_mask}.yaml`` and the
``data_paths/{fw70_2m,nusc}.yaml`` group, each exactly as PyYAML parses it;
tests hold them equal.
"""
from __future__ import annotations

POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES = ["Dynamic"]
POINTRCNN_DYNAMIC_OBJ_NUM_POINTS = 12288

POINTRCNN_DYNAMIC_OBJ = {
    "NAME": "PointRCNN",
    "BACKBONE_3D": {
        "NAME": "PointNet2MSG",
        "SA_CONFIG": {
            "NPOINTS": [4096, 1024, 256, 64],
            "RADIUS": [[0.1, 0.5], [0.5, 1.0], [1.0, 2.0], [2.0, 4.0]],
            "NSAMPLE": [[16, 32], [16, 32], [16, 32], [16, 32]],
            "MLPS": [[[16, 16, 32], [32, 32, 64]],
                     [[64, 64, 128], [64, 96, 128]],
                     [[128, 196, 256], [128, 196, 256]],
                     [[256, 256, 512], [256, 384, 512]]],
        },
        "FP_MLPS": [[128, 128], [256, 256], [512, 512], [512, 512]],
    },
    "POINT_HEAD": {
        "NAME": "PointHeadBox",
        "CLS_FC": [256, 256],
        "REG_FC": [256, 256],
        "CLASS_AGNOSTIC": False,
        "USE_POINT_FEATURES_BEFORE_FUSION": False,
        "TARGET_CONFIG": {
            "GT_EXTRA_WIDTH": [0.2, 0.2, 0.2],
            "BOX_CODER": "PointResidualCoder",
            "BOX_CODER_CONFIG": {
                "use_mean_size": True,
                "mean_size": [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]],
            },
        },
        "LOSS_CONFIG": {
            "LOSS_REG": "WeightedSmoothL1Loss",
            "LOSS_WEIGHTS": {
                "point_cls_weight": 1.0,
                "point_box_weight": 1.0,
                "code_weights": [1.0] * 8,
            },
        },
    },
    "ROI_HEAD": {
        "NAME": "PointRCNNHead",
        "CLASS_AGNOSTIC": True,
        "ROI_POINT_POOL": {
            "POOL_EXTRA_WIDTH": [0.0, 0.0, 0.0],
            "NUM_SAMPLED_POINTS": 512,
            "DEPTH_NORMALIZER": 70.0,
        },
        "XYZ_UP_LAYER": [128, 128],
        "CLS_FC": [256, 256],
        "REG_FC": [256, 256],
        "DP_RATIO": 0.0,
        "USE_BN": False,
        "SA_CONFIG": {
            "NPOINTS": [128, 32, -1],
            "RADIUS": [0.2, 0.4, 100],
            "NSAMPLE": [16, 16, 16],
            "MLPS": [[128, 128, 128], [128, 128, 256], [256, 256, 512]],
        },
        "NMS_CONFIG": {
            "TRAIN": {
                "NMS_TYPE": "nms_gpu",
                "MULTI_CLASSES_NMS": False,
                "NMS_PRE_MAXSIZE": 9000,
                "NMS_POST_MAXSIZE": 512,
                "NMS_THRESH": 0.8,
            },
            "TEST": {
                "NMS_TYPE": "nms_gpu",
                "MULTI_CLASSES_NMS": False,
                "NMS_PRE_MAXSIZE": 9000,
                "NMS_POST_MAXSIZE": 100,
                "NMS_THRESH": 0.85,
            },
        },
        "TARGET_CONFIG": {
            "BOX_CODER": "ResidualCoder",
            "ROI_PER_IMAGE": 128,
            "FG_RATIO": 0.5,
            "SAMPLE_ROI_BY_EACH_CLASS": True,
            "CLS_SCORE_TYPE": "cls",
            "CLS_FG_THRESH": 0.6,
            "CLS_BG_THRESH": 0.45,
            "CLS_BG_THRESH_LO": 0.1,
            "HARD_BG_RATIO": 0.8,
            "REG_FG_THRESH": 0.55,
        },
        "LOSS_CONFIG": {
            "CLS_LOSS": "BinaryCrossEntropy",
            "REG_LOSS": "smooth-l1",
            "CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {
                "rcnn_cls_weight": 1.0,
                "rcnn_reg_weight": 1.0,
                "rcnn_corner_weight": 1.0,
                "code_weights": [1.0] * 7,
            },
        },
    },
    "POST_PROCESSING": {
        "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
        "SCORE_THRESH": 0.1,
        "OUTPUT_RAW_SCORE": False,
        "EVAL_METRIC": "kitti",
        "NMS_CONFIG": {
            "MULTI_CLASSES_NMS": False,
            "NMS_TYPE": "nms_gpu",
            "NMS_THRESH": 0.1,
            "NMS_PRE_MAXSIZE": 4096,
            "NMS_POST_MAXSIZE": 500,
        },
    },
}


POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG = {
    "DATASET": "KittiDataset",
    "DATA_PATH": "data/lyft",
    "POINT_CLOUD_RANGE": [0, -40, -3, 90.4, 40, 1],
    "DATA_SPLIT": {"train": "train", "test": "val"},
    "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
    "GET_ITEM_LIST": ["points"],
    "FOV_POINTS_ONLY": True,
    "DATA_AUGMENTOR": {
        "DISABLE_AUG_LIST": ["placeholder"],
        "AUG_CONFIG_LIST": [
            {"NAME": "gt_sampling", "USE_ROAD_PLANE": True,
             "DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
             "PREPARE": {"filter_by_min_points": ["Dynamic:5"], "filter_by_difficulty": []},
             "SAMPLE_GROUPS": ["Dynamic:40"], "NUM_POINT_FEATURES": 4,
             "DATABASE_WITH_FAKELIDAR": False, "REMOVE_EXTRA_WIDTH": [0.0, 0.0, 0.0],
             "LIMIT_WHOLE_SCENE": True},
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
            {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        ],
    },
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"],
    },
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "sample_points", "NUM_POINTS": {"train": POINTRCNN_DYNAMIC_OBJ_NUM_POINTS,
                                                 "test": POINTRCNN_DYNAMIC_OBJ_NUM_POINTS}},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
    ],
}

POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION = {
    "BATCH_SIZE_PER_GPU": 2,
    "NUM_EPOCHS": 60,
    "OPTIMIZER": "adam_onecycle",
    "LR": 0.01,
    "WEIGHT_DECAY": 0.01,
    "MOMENTUM": 0.9,
    "MOMS": [0.95, 0.85],
    "PCT_START": 0.4,
    "DIV_FACTOR": 10,
    "DECAY_STEP_LIST": [35, 45],
    "LR_DECAY": 0.1,
    "LR_CLIP": 1e-07,
    "LR_WARMUP": False,
    "WARMUP_EPOCH": 1,
    "GRAD_NORM_CLIP": 10,
}

POINTRCNN_DYNAMIC_OBJ_FULL = {
    "CLASS_NAMES": POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES,
    "DATA_CONFIG": POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG,
    "MODEL": POINTRCNN_DYNAMIC_OBJ,
    "OPTIMIZATION": POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION,
}


# ---------------------------------------------------------------------------
# The grid detectors: configs/models/lyft_models/{pointpillar,second}_dynamic_obj.yaml,
# each whole with the same dataset base merged in. Both sample 65536 points
# a scan for the on-device voxelizer and record the voxel grid.
# ---------------------------------------------------------------------------

GRID_NUM_POINTS = 65536


def _grid_data_config(point_cloud_range, voxel_size, max_points_per_voxel: int,
                      limit_whole_scene: bool):
    import copy

    data = copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    data["POINT_CLOUD_RANGE"] = point_cloud_range
    data["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]["LIMIT_WHOLE_SCENE"] = limit_whole_scene
    data["DATA_PROCESSOR"] = [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "sample_points", "NUM_POINTS": {"train": GRID_NUM_POINTS,
                                                 "test": GRID_NUM_POINTS}},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
        {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": voxel_size,
         "MAX_POINTS_PER_VOXEL": max_points_per_voxel,
         "MAX_NUMBER_OF_VOXELS": {"train": 16000, "test": 40000}},
    ]
    return data


def _grid_model_config(name: str, feature_map_stride: int, **parts):
    anchor = {
        "class_name": "Dynamic",
        "anchor_sizes": [[2.0, 1.0, 1.7]],
        "anchor_rotations": [0, 1.57],
        "anchor_bottom_heights": [-1.6],
        "align_center": False,
        "feature_map_stride": feature_map_stride,
        "matched_threshold": 0.5,
        "unmatched_threshold": 0.35,
    }
    return {
        "NAME": name,
        **parts,
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle",
            "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True,
            "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0,
            "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [anchor],
            "TARGET_ASSIGNER_CONFIG": {
                "NAME": "AxisAlignedTargetAssigner",
                "POS_FRACTION": -1.0,
                "SAMPLE_SIZE": 512,
                "NORM_BY_NUM_EXAMPLES": False,
                "MATCH_HEIGHT": False,
                "BOX_CODER": "ResidualCoder",
            },
            "LOSS_CONFIG": {
                "LOSS_WEIGHTS": {
                    "cls_weight": 1.0,
                    "loc_weight": 2.0,
                    "dir_weight": 0.2,
                    "code_weights": [1.0] * 7,
                },
            },
        },
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": 0.1,
            "OUTPUT_RAW_SCORE": False,
            "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {
                "MULTI_CLASSES_NMS": False,
                "NMS_TYPE": "nms_gpu",
                "NMS_THRESH": 0.01,
                "NMS_PRE_MAXSIZE": 4096,
                "NMS_POST_MAXSIZE": 500,
            },
        },
    }


GRID_OPTIMIZATION = {**POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION, "BATCH_SIZE_PER_GPU": 4,
                     "LR": 0.003}

POINTPILLAR_DYNAMIC_OBJ = _grid_model_config(
    "PointPillar", 2,
    VFE={"NAME": "PillarVFE", "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
         "USE_NORM": True, "NUM_FILTERS": [64]},
    MAP_TO_BEV={"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 64},
    BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [3, 5, 5], "LAYER_STRIDES": [2, 2, 2],
                 "NUM_FILTERS": [64, 128, 256], "UPSAMPLE_STRIDES": [1, 2, 4],
                 "NUM_UPSAMPLE_FILTERS": [128, 128, 128]},
)

POINTPILLAR_DYNAMIC_OBJ_FULL = {
    "CLASS_NAMES": ["Dynamic"],
    "DATA_CONFIG": _grid_data_config([0, -39.68, -3, 89.6, 39.68, 1], [0.16, 0.16, 4], 32,
                                     limit_whole_scene=False),
    "MODEL": POINTPILLAR_DYNAMIC_OBJ,
    "OPTIMIZATION": GRID_OPTIMIZATION,
}

SECOND_DYNAMIC_OBJ = _grid_model_config(
    "SECONDNet", 8,
    VFE={"NAME": "MeanVFE"},
    BACKBONE_3D={"NAME": "VoxelBackBone8x"},
    MAP_TO_BEV={"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
    BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [5, 5], "LAYER_STRIDES": [1, 2],
                 "NUM_FILTERS": [128, 256], "UPSAMPLE_STRIDES": [1, 2],
                 "NUM_UPSAMPLE_FILTERS": [256, 256]},
)

SECOND_DYNAMIC_OBJ_FULL = {
    "CLASS_NAMES": ["Dynamic"],
    "DATA_CONFIG": _grid_data_config([0, -40, -3, 90.4, 40, 1], [0.05, 0.05, 0.1], 5,
                                     limit_whole_scene=True),
    "MODEL": SECOND_DYNAMIC_OBJ,
    "OPTIMIZATION": GRID_OPTIMIZATION,
}

# PV-RCNN: configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml, the SECOND file's
# data and stage 1 with the keypoint set abstraction and the RoI-grid head
# (pcdet's kitti_models/pv_rcnn.yaml heads), at the flagship's optimization


def _sa(mlps, radii, nsamples, downsample=None):
    layer = {} if downsample is None else {"DOWNSAMPLE_FACTOR": downsample}
    return {**layer, "MLPS": mlps, "POOL_RADIUS": radii, "NSAMPLE": nsamples}


def _pv_rcnn_model_config():
    base = _grid_model_config("PVRCNN", 8)
    return {
        "NAME": "PVRCNN",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": SECOND_DYNAMIC_OBJ["BACKBONE_2D"],
        "DENSE_HEAD": base["DENSE_HEAD"],
        "PFE": {
            "NAME": "VoxelSetAbstraction",
            "POINT_SOURCE": "raw_points",
            "NUM_KEYPOINTS": 2048,
            "NUM_OUTPUT_FEATURES": 128,
            "SAMPLE_METHOD": "FPS",
            "FEATURES_SOURCE": ["bev", "x_conv1", "x_conv2", "x_conv3", "x_conv4", "raw_points"],
            "SA_LAYER": {
                "raw_points": _sa([[16, 16], [16, 16]], [0.4, 0.8], [16, 16]),
                "x_conv1": _sa([[16, 16], [16, 16]], [0.4, 0.8], [16, 16], 1),
                "x_conv2": _sa([[32, 32], [32, 32]], [0.8, 1.2], [16, 32], 2),
                "x_conv3": _sa([[64, 64], [64, 64]], [1.2, 2.4], [16, 32], 4),
                "x_conv4": _sa([[64, 64], [64, 64]], [2.4, 4.8], [16, 32], 8),
            },
        },
        "POINT_HEAD": {
            "NAME": "PointHeadSimple",
            "CLS_FC": [256, 256],
            "CLASS_AGNOSTIC": True,
            "USE_POINT_FEATURES_BEFORE_FUSION": True,
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]},
            "LOSS_CONFIG": {"LOSS_REG": "smooth-l1",
                            "LOSS_WEIGHTS": {"point_cls_weight": 1.0}},
        },
        "ROI_HEAD": {
            "NAME": "PVRCNNHead",
            "CLASS_AGNOSTIC": True,
            "SHARED_FC": [256, 256],
            "CLS_FC": [256, 256],
            "REG_FC": [256, 256],
            "DP_RATIO": 0.3,
            "NMS_CONFIG": {
                "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                          "NMS_PRE_MAXSIZE": 9000, "NMS_POST_MAXSIZE": 512,
                          "NMS_THRESH": 0.8},
                "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                         "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 100,
                         "NMS_THRESH": 0.7},
            },
            "ROI_GRID_POOL": {"GRID_SIZE": 6, "MLPS": [[64, 64], [64, 64]],
                              "POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [16, 16],
                              "POOL_METHOD": "max_pool"},
            "TARGET_CONFIG": {
                "BOX_CODER": "ResidualCoder",
                "ROI_PER_IMAGE": 128,
                "FG_RATIO": 0.5,
                "SAMPLE_ROI_BY_EACH_CLASS": True,
                "CLS_SCORE_TYPE": "roi_iou",
                "CLS_FG_THRESH": 0.75,
                "CLS_BG_THRESH": 0.25,
                "CLS_BG_THRESH_LO": 0.1,
                "HARD_BG_RATIO": 0.8,
                "REG_FG_THRESH": 0.55,
            },
            "LOSS_CONFIG": {
                "CLS_LOSS": "BinaryCrossEntropy",
                "REG_LOSS": "smooth-l1",
                "CORNER_LOSS_REGULARIZATION": True,
                "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                                 "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7},
            },
        },
        "POST_PROCESSING": {**base["POST_PROCESSING"],
                            "NMS_CONFIG": {**base["POST_PROCESSING"]["NMS_CONFIG"],
                                           "NMS_THRESH": 0.1}},
    }


PV_RCNN_DYNAMIC_OBJ = _pv_rcnn_model_config()

PV_RCNN_DYNAMIC_OBJ_FULL = {
    "CLASS_NAMES": ["Dynamic"],
    "DATA_CONFIG": SECOND_DYNAMIC_OBJ_FULL["DATA_CONFIG"],
    "MODEL": PV_RCNN_DYNAMIC_OBJ,
    "OPTIMIZATION": POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION,
}

# The two-stage heads on the SECOND base: configs/models/lyft_models/
# {second_iou,voxel_rcnn,part_a2}_dynamic_obj.yaml, each with SECOND's data
# section; SECOND-IoU trains at SECOND's optimization, the other two at the
# flagship's


def _rcnn_target_and_loss():
    return {
        "TARGET_CONFIG": PV_RCNN_DYNAMIC_OBJ["ROI_HEAD"]["TARGET_CONFIG"],
        "LOSS_CONFIG": PV_RCNN_DYNAMIC_OBJ["ROI_HEAD"]["LOSS_CONFIG"],
    }


def _two_stage_model_config(name: str, backbone_3d: str, **heads):
    post = PV_RCNN_DYNAMIC_OBJ["POST_PROCESSING"] if name != "SECONDNetIoU" \
        else SECOND_DYNAMIC_OBJ["POST_PROCESSING"]
    return {
        "NAME": name,
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": backbone_3d},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": SECOND_DYNAMIC_OBJ["BACKBONE_2D"],
        "DENSE_HEAD": SECOND_DYNAMIC_OBJ["DENSE_HEAD"],
        **heads,
        "POST_PROCESSING": post,
    }


def _nms(pre_train: int, pre_test: int, **keys):
    return {"TRAIN": {**keys, "NMS_PRE_MAXSIZE": pre_train, "NMS_POST_MAXSIZE": 512,
                      "NMS_THRESH": 0.8},
            "TEST": {**keys, "NMS_PRE_MAXSIZE": pre_test, "NMS_POST_MAXSIZE": 100,
                     "NMS_THRESH": 0.7}}


_NMS_KEYS = {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False}

SECOND_IOU_DYNAMIC_OBJ = _two_stage_model_config(
    "SECONDNetIoU", "VoxelBackBone8x",
    ROI_HEAD={"NAME": "SECONDHead", "CLASS_AGNOSTIC": True, "GRID_SIZE": 7,
              "SHARED_FC": [256, 256], "IOU_FC": [256, 256], "NMS_CONFIG": _nms(9000, 1024),
              "LOSS_CONFIG": {"LOSS_WEIGHTS": {"rcnn_iou_weight": 1.0}}},
)


def _voxel_pool(radius: float):
    return {"MLPS": [[32, 32]], "QUERY_RANGES": [[4, 4, 4]], "POOL_RADIUS": [radius],
            "NSAMPLE": [16], "POOL_METHOD": "max_pool"}


VOXEL_RCNN_DYNAMIC_OBJ = _two_stage_model_config(
    "VoxelRCNN", "VoxelBackBone8x",
    ROI_HEAD={"NAME": "VoxelRCNNHead", "CLASS_AGNOSTIC": True, "SHARED_FC": [256, 256],
              "CLS_FC": [256, 256], "REG_FC": [256, 256], "DP_RATIO": 0.3,
              "NMS_CONFIG": _nms(9000, 1024, **_NMS_KEYS),
              "ROI_GRID_POOL": {"GRID_SIZE": 6,
                                "FEATURES_SOURCE": ["x_conv2", "x_conv3", "x_conv4"],
                                "POOL_LAYERS": {"x_conv2": _voxel_pool(0.4),
                                                "x_conv3": _voxel_pool(0.8),
                                                "x_conv4": _voxel_pool(1.6)}},
              **_rcnn_target_and_loss()},
)

PART_A2_DYNAMIC_OBJ = _two_stage_model_config(
    "PartA2", "UNetV2",
    POINT_HEAD={"NAME": "PointIntraPartOffsetHead", "CLS_FC": [128], "PART_FC": [128],
                "CLASS_AGNOSTIC": True,
                "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0,
                                                 "point_part_weight": 1.0}}},
    ROI_HEAD={"NAME": "PartA2FCHead", "CLASS_AGNOSTIC": True, "SHARED_FC": [256, 256],
              "CLS_FC": [256, 256], "REG_FC": [256, 256], "DP_RATIO": 0.3,
              "NMS_CONFIG": _nms(9000, 1024, **_NMS_KEYS),
              "ROI_AWARE_POOL": {"POOL_SIZE": 12, "NUM_FEATURES": 128,
                                 "MAX_POINTS_PER_VOXEL": 128},
              "CONV_TOWER": {"NUM_FILTERS": [128, 128, 128], "STRIDES": [1, 2, 2]},
              **_rcnn_target_and_loss()},
)


def _second_based(model, optimization):
    return {"CLASS_NAMES": ["Dynamic"], "DATA_CONFIG": SECOND_DYNAMIC_OBJ_FULL["DATA_CONFIG"],
            "MODEL": model, "OPTIMIZATION": optimization}


SECOND_IOU_DYNAMIC_OBJ_FULL = _second_based(SECOND_IOU_DYNAMIC_OBJ, GRID_OPTIMIZATION)
VOXEL_RCNN_DYNAMIC_OBJ_FULL = _second_based(VOXEL_RCNN_DYNAMIC_OBJ,
                                            POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION)
PART_A2_DYNAMIC_OBJ_FULL = _second_based(PART_A2_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION)

# nuScenes-Boston, the paper's second dataset:
# configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml is the
# flagship's model at 6144 points a scan and 80 epochs, on its base
# configs/datasets/nuscenes_boston_dynamic_obj.yaml (the Lyft base with its own
# data path and the gt database's min-point filter by Car and Pedestrian)
NUSCENES_BOSTON_NUM_POINTS = 6144


def _nuscenes_boston_data_config():
    import copy

    data = copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    data["DATA_PATH"] = "data/nuscenes_boston"
    data["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]["PREPARE"]["filter_by_min_points"] = [
        "Car:5", "Pedestrian:5"]
    data["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUSCENES_BOSTON_NUM_POINTS,
                                               "test": NUSCENES_BOSTON_NUM_POINTS}
    return data


NUSCENES_BOSTON_POINTRCNN_DYNAMIC_OBJ_FULL = {
    "CLASS_NAMES": ["Dynamic"],
    "DATA_CONFIG": _nuscenes_boston_data_config(),
    "MODEL": POINTRCNN_DYNAMIC_OBJ,
    "OPTIMIZATION": {**POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION, "NUM_EPOCHS": 80},
}

# ---------------------------------------------------------------------------
# KITTI, the reference's benchmark: configs/models/kitti_models/<name>.yaml on
# configs/datasets/kitti_dataset.yaml, whole in KITTI_CONFIGS. Three classes
# (voxel_rcnn_car: Car), KITTI's range [0, -40, -3, 70.4, 40, 1] (PointPillars'
# cut to its pillar grid). Every model section but the multi-head SECOND's and
# PartA2_free's is the Lyft file's with KITTI's anchors; the optimizations
# differ from the flagship's only in batch, rate and epochs.
# ---------------------------------------------------------------------------

KITTI_CLASS_NAMES = ["Car", "Pedestrian", "Cyclist"]
KITTI_NUM_POINTS = 16384  # the point-based detectors' sample (kitti_models/pointrcnn.yaml)

KITTI_DATA_BASE = {
    "DATASET": "KittiDataset", "DATA_PATH": "data/kitti",
    "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
    "DATA_SPLIT": {"train": "train", "test": "val"},
    "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
    "GET_ITEM_LIST": ["points"], "FOV_POINTS_ONLY": True, "CONSTANT_REFLEX": 100.0,
    "DATA_AUGMENTOR": {
        "DISABLE_AUG_LIST": ["placeholder"],
        "AUG_CONFIG_LIST": [
            {
                "NAME": "gt_sampling", "USE_ROAD_PLANE": True,
                "DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
                "PREPARE": {"filter_by_min_points": ["Car:5", "Pedestrian:5", "Cyclist:5"],
                            "filter_by_difficulty": [-1]},
                "SAMPLE_GROUPS": ["Car:20", "Pedestrian:15", "Cyclist:15"],
                "NUM_POINT_FEATURES": 4, "DATABASE_WITH_FAKELIDAR": False,
                "REMOVE_EXTRA_WIDTH": [0.0, 0.0, 0.0], "LIMIT_WHOLE_SCENE": True,
            },
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
            {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        ],
    },
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity"],
        "src_feature_list": ["x", "y", "z", "intensity"],
    },
}


def _kitti_data_config(voxel_size=None, max_points_per_voxel: int = 5, **changes):
    """The dataset base with a file's processors: sampled to
    KITTI_NUM_POINTS a scan for the point-based detectors, to
    GRID_NUM_POINTS and voxelized at ``voxel_size`` for the grid ones."""
    import copy

    data = {**copy.deepcopy(KITTI_DATA_BASE), **changes}
    n = KITTI_NUM_POINTS if voxel_size is None else GRID_NUM_POINTS
    data["DATA_PROCESSOR"] = [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "sample_points", "NUM_POINTS": {"train": n, "test": n}},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
    ]
    if voxel_size is not None:
        data["DATA_PROCESSOR"].append(
            {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": voxel_size,
             "MAX_POINTS_PER_VOXEL": max_points_per_voxel,
             "MAX_NUMBER_OF_VOXELS": {"train": 16000, "test": 40000}})
    return data


def _kitti_anchors(stride: int = 8, bottoms=(-1.78, -0.6, -0.6), classes: int = 3):
    """KITTI's anchor configs, in CLASS_NAMES order."""
    cfgs = [("Car", [3.9, 1.6, 1.56], 0.6, 0.45), ("Pedestrian", [0.8, 0.6, 1.73], 0.5, 0.35),
            ("Cyclist", [1.76, 0.6, 1.73], 0.5, 0.35)]
    return [{"class_name": name, "anchor_sizes": [size], "anchor_rotations": [0, 1.57],
             "anchor_bottom_heights": [bottom], "align_center": False,
             "feature_map_stride": stride, "matched_threshold": matched,
             "unmatched_threshold": unmatched}
            for (name, size, matched, unmatched), bottom in zip(cfgs[:classes], bottoms)]


def _with_anchors(model, anchors):
    return {**model, "DENSE_HEAD": {**model["DENSE_HEAD"], "ANCHOR_GENERATOR_CONFIG": anchors}}


def _kitti_optimization(batch: int, lr: float):
    return {**POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION, "BATCH_SIZE_PER_GPU": batch, "NUM_EPOCHS": 80,
            "LR": lr}


KITTI_POINTRCNN = POINTRCNN_DYNAMIC_OBJ
KITTI_POINTRCNN_IOU = {
    **POINTRCNN_DYNAMIC_OBJ,
    "ROI_HEAD": {**POINTRCNN_DYNAMIC_OBJ["ROI_HEAD"], "TARGET_CONFIG": {
        **POINTRCNN_DYNAMIC_OBJ["ROI_HEAD"]["TARGET_CONFIG"], "CLS_SCORE_TYPE": "roi_iou",
        "CLS_FG_THRESH": 0.7, "CLS_BG_THRESH": 0.25}},
}
KITTI_SECOND = _with_anchors(SECOND_DYNAMIC_OBJ, _kitti_anchors())
KITTI_POINTPILLAR = _with_anchors(POINTPILLAR_DYNAMIC_OBJ, _kitti_anchors(stride=2))
_SECOND_HEAD = SECOND_DYNAMIC_OBJ["DENSE_HEAD"]
KITTI_SECOND_MULTIHEAD = {**SECOND_DYNAMIC_OBJ, "DENSE_HEAD": {
    "NAME": "AnchorHeadMulti",
    **{k: _SECOND_HEAD[k] for k in ("CLASS_AGNOSTIC", "USE_DIRECTION_CLASSIFIER", "DIR_OFFSET",
                                    "DIR_LIMIT_OFFSET", "NUM_DIR_BINS")},
    "USE_MULTIHEAD": True, "SEPARATE_MULTIHEAD": True,
    "ANCHOR_GENERATOR_CONFIG": _kitti_anchors(bottoms=(-1.6, -1.6, -1.6)),
    "SHARED_CONV_NUM_FILTER": 64,
    "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": [name]} for name in KITTI_CLASS_NAMES],
    **{k: _SECOND_HEAD[k] for k in ("TARGET_ASSIGNER_CONFIG", "LOSS_CONFIG")},
}}
KITTI_PV_RCNN = _with_anchors(PV_RCNN_DYNAMIC_OBJ, _kitti_anchors())
KITTI_SECOND_IOU = _with_anchors(SECOND_IOU_DYNAMIC_OBJ, _kitti_anchors())
KITTI_PART_A2 = _with_anchors(PART_A2_DYNAMIC_OBJ, _kitti_anchors())
KITTI_VOXEL_RCNN_CAR = _with_anchors(VOXEL_RCNN_DYNAMIC_OBJ, _kitti_anchors(classes=1))

# PartA2_free: NAME PointRCNN on the UNetV2 backbone (PartA2Free), a point head
# with mean-size residuals, Part-A2's RoI tower with DISABLE_PART
_PART_A2_ROI = PART_A2_DYNAMIC_OBJ["ROI_HEAD"]
KITTI_PART_A2_FREE = {
    "NAME": "PointRCNN", "VFE": {"NAME": "MeanVFE"},
    "BACKBONE_3D": {"NAME": "UNetV2", "RETURN_ENCODED_TENSOR": False},
    "POINT_HEAD": {
        "NAME": "PointIntraPartOffsetHead", "CLS_FC": [128, 128], "PART_FC": [128, 128],
        "REG_FC": [128, 128], "CLASS_AGNOSTIC": False, "USE_POINT_FEATURES_BEFORE_FUSION": False,
        "TARGET_CONFIG": POINTRCNN_DYNAMIC_OBJ["POINT_HEAD"]["TARGET_CONFIG"],
        "LOSS_CONFIG": {
            "LOSS_REG": "WeightedSmoothL1Loss",
            "LOSS_WEIGHTS": {"point_cls_weight": 1.0, "point_box_weight": 1.0,
                             "point_part_weight": 1.0, "code_weights": [1.0] * 8},
        },
    },
    "ROI_HEAD": {
        **{k: _PART_A2_ROI[k] for k in ("NAME", "CLASS_AGNOSTIC")}, "SHARED_FC": [256, 256, 256],
        **{k: _PART_A2_ROI[k] for k in ("CLS_FC", "REG_FC", "DP_RATIO")},
        "DISABLE_PART": True, "SEG_MASK_SCORE_THRESH": 0.0,
        "NMS_CONFIG": {"TRAIN": _PART_A2_ROI["NMS_CONFIG"]["TRAIN"],
                       "TEST": {**_PART_A2_ROI["NMS_CONFIG"]["TEST"], "NMS_PRE_MAXSIZE": 9000,
                                "NMS_THRESH": 0.85}},
        **{k: _PART_A2_ROI[k] for k in ("ROI_AWARE_POOL", "CONV_TOWER")},
        "TARGET_CONFIG": {**_PART_A2_ROI["TARGET_CONFIG"], "REG_FG_THRESH": 0.65},
        "LOSS_CONFIG": _PART_A2_ROI["LOSS_CONFIG"],
    },
    "POST_PROCESSING": PART_A2_DYNAMIC_OBJ["POST_PROCESSING"],
}


def _kitti_full(model, batch: int, lr: float, voxel_size=(0.05, 0.05, 0.1), classes=None,
                **data):
    return {"CLASS_NAMES": list(classes or KITTI_CLASS_NAMES),
            "DATA_CONFIG": _kitti_data_config(None if voxel_size is None else list(voxel_size),
                                              **data),
            "MODEL": model, "OPTIMIZATION": _kitti_optimization(batch, lr)}


_PILLAR_AUGMENTOR = {"DISABLE_AUG_LIST": ["placeholder"], "AUG_CONFIG_LIST": [
    {**KITTI_DATA_BASE["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0],
     "SAMPLE_GROUPS": ["Car:15", "Pedestrian:15", "Cyclist:15"], "LIMIT_WHOLE_SCENE": False},
    *KITTI_DATA_BASE["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][1:]]}
# CaDDN (camera only): the compact stride-4 image encoder (CaDDN.yaml) and the
# reference's DeepLabV3 + ResNet-101 DDN with a 1x1 channel reduce
# (CaDDN_deeplab.yaml, on CaDDN.yaml); 80 LID depth bins over 2-46.8 m, the
# frustum sampled into a 280 x 376 x 25 grid of 0.16 m voxels
KITTI_CADDN = _with_anchors(_grid_model_config(
    "CaDDN", 2,
    FFE={"NAME": "DepthFFE", "ENCODER_CHANNELS": [32, 64], "NUM_FEATURES": 64,
         "DISC_CFG": {"mode": "LID", "num_bins": 80, "depth_min": 2.0, "depth_max": 46.8},
         "LOSS_CONFIG": {"LOSS_WEIGHTS": {"ddn_loss_weight": 3.0, "fg_weight": 13.0,
                                          "bg_weight": 1.0}}},
    MAP_TO_BEV={"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 64},
    BACKBONE_2D={"NAME": "BaseBEVBackbone", "LAYER_NUMS": [10, 10, 10],
                 "LAYER_STRIDES": [2, 2, 2], "NUM_FILTERS": [64, 128, 256],
                 "UPSAMPLE_STRIDES": [1, 2, 4], "NUM_UPSAMPLE_FILTERS": [128, 128, 128]}),
    _kitti_anchors(stride=2))
KITTI_CADDN_DEEPLAB = {**KITTI_CADDN, "FFE": {
    **KITTI_CADDN["FFE"],
    "DDN": {"NAME": "DDNDeepLabV3", "BACKBONE_NAME": "ResNet101", "FEAT_EXTRACT_LAYER": "layer1"},
    "CHANNEL_REDUCE": {"in_channels": 256, "out_channels": 64, "kernel_size": 1, "stride": 1,
                       "bias": False}}}


def _caddn_data_config():
    """CaDDN.yaml's DATA_CONFIG: the camera items, the depth-map downsample
    and the image flip on the KITTI base."""
    import copy

    data = {**copy.deepcopy(KITTI_DATA_BASE),
            "POINT_CLOUD_RANGE": [2, -30.08, -3.0, 46.8, 30.08, 1.0],
            "GET_ITEM_LIST": ["points", "images", "depth_maps", "calib_matricies", "gt_boxes2d"],
            "DATA_AUGMENTOR": {"DISABLE_AUG_LIST": ["placeholder"], "AUG_CONFIG_LIST": [
                {"NAME": "random_image_flip", "ALONG_AXIS_LIST": ["horizontal"]}]}}
    data["DATA_PROCESSOR"] = [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "sample_points", "NUM_POINTS": {"train": KITTI_NUM_POINTS,
                                                 "test": KITTI_NUM_POINTS}},
        {"NAME": "calculate_grid_size", "VOXEL_SIZE": [0.16, 0.16, 0.16]},
        {"NAME": "downsample_depth_map", "DOWNSAMPLE_FACTOR": 4},
    ]
    data["IMAGE_PAD"] = [384, 1248]
    return data


def _caddn_full(model):
    return {"CLASS_NAMES": list(KITTI_CLASS_NAMES), "DATA_CONFIG": _caddn_data_config(),
            "MODEL": model, "OPTIMIZATION": _kitti_optimization(4, 0.001)}


KITTI_CONFIGS = {  # file stem under configs/models/kitti_models → the whole file
    "pointrcnn": _kitti_full(KITTI_POINTRCNN, 2, 0.01, voxel_size=None),
    "pointrcnn_iou": _kitti_full(KITTI_POINTRCNN_IOU, 3, 0.01, voxel_size=None),
    "second": _kitti_full(KITTI_SECOND, 4, 0.003),
    "pointpillar": _kitti_full(KITTI_POINTPILLAR, 4, 0.003, voxel_size=(0.16, 0.16, 4),
                               max_points_per_voxel=32,
                               POINT_CLOUD_RANGE=[0, -39.68, -3, 69.12, 39.68, 1],
                               DATA_AUGMENTOR=_PILLAR_AUGMENTOR),
    "second_multihead": _kitti_full(KITTI_SECOND_MULTIHEAD, 4, 0.003),
    "pv_rcnn": _kitti_full(KITTI_PV_RCNN, 2, 0.01),
    "second_iou": _kitti_full(KITTI_SECOND_IOU, 4, 0.003),
    "PartA2": _kitti_full(KITTI_PART_A2, 2, 0.01),
    "PartA2_free": _kitti_full(KITTI_PART_A2_FREE, 4, 0.01),
    "voxel_rcnn_car": _kitti_full(KITTI_VOXEL_RCNN_CAR, 2, 0.01, classes=["Car"]),
    "CaDDN": _caddn_full(KITTI_CADDN),
    "CaDDN_deeplab": _caddn_full(KITTI_CADDN_DEEPLAB),
}

# ---------------------------------------------------------------------------
# nuScenes and Waymo: configs/datasets/{nuscenes,waymo}_dataset.yaml as
# NUSCENES_DATASET_BASE and WAYMO_DATASET_BASE, and the model files on them,
# whole: configs/models/nuscenes_models/cbgs_{second,pp}_multihead.yaml
# (CBGS_{SECOND,PP}_MULTIHEAD their MODEL sections) and
# configs/models/waymo_models/{pv_rcnn,second,PartA2}.yaml (the Lyft files'
# model sections with Waymo's three anchors).
# ---------------------------------------------------------------------------

NUSCENES_DATASET_BASE = {
    "DATASET": "NuScenesDataset", "DATA_PATH": "data/nuscenes", "VERSION": "v1.0-trainval",
    "MAX_SWEEPS": 10, "PRED_VELOCITY": True, "SET_NAN_VELOCITY_TO_ZEROS": True,
    "FILTER_MIN_POINTS_IN_GT": 1, "BALANCED_RESAMPLING": True,
    "DATA_SPLIT": {"train": "train", "test": "val"},
    "INFO_PATH": {"train": ["nuscenes_infos_train_10sweeps_withvelo.pkl"],
                  "test": ["nuscenes_infos_val_10sweeps_withvelo.pkl"]},
    "POINT_CLOUD_RANGE": [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
    "DATA_AUGMENTOR": {
        "DISABLE_AUG_LIST": ["placeholder"],
        "AUG_CONFIG_LIST": [
            {
                "NAME": "gt_sampling", "USE_ROAD_PLANE": False,
                "DB_INFO_PATH": ["nuscenes_dbinfos_10sweeps_withvelo.pkl"],
                "PREPARE": {"filter_by_min_points": [
                    f"{name}:5" for name in (
                        "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                        "motorcycle", "bicycle", "pedestrian", "traffic_cone")]},
                "SAMPLE_GROUPS": ["car:2", "truck:3", "construction_vehicle:7", "bus:4",
                                  "trailer:6", "barrier:2", "motorcycle:6", "bicycle:6",
                                  "pedestrian:2", "traffic_cone:2"],
                "NUM_POINT_FEATURES": 5, "REMOVE_EXTRA_WIDTH": [0.0, 0.0, 0.0],
                "LIMIT_WHOLE_SCENE": True,
            },
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.3925, 0.3925]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        ],
    },
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity", "timestamp"],
        "src_feature_list": ["x", "y", "z", "intensity", "timestamp"],
    },
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": True}},
        {"NAME": "sample_points", "NUM_POINTS": {"train": 65536, "test": 65536}},
    ],
}

WAYMO_NUM_POINTS = 131072  # each Waymo model file's sample, train and test
WAYMO_DATASET_BASE = {
    "DATASET": "WaymoDataset", "DATA_PATH": "data/waymo",
    "PROCESSED_DATA_TAG": "waymo_processed_data",
    "POINT_CLOUD_RANGE": [-75.2, -75.2, -2, 75.2, 75.2, 4],
    "DATA_SPLIT": {"train": "train", "test": "val"},
    "SAMPLED_INTERVAL": {"train": 5, "test": 5},
    "EVAL_METRIC": "kitti",
    "DATA_AUGMENTOR": {
        "DISABLE_AUG_LIST": ["placeholder"],
        "AUG_CONFIG_LIST": [
            {
                "NAME": "gt_sampling", "USE_ROAD_PLANE": False,
                "DB_INFO_PATH": ["pcdet_waymo_dbinfos_train_sampled_10.pkl"],
                "PREPARE": {"filter_by_min_points": ["Vehicle:5", "Pedestrian:5", "Cyclist:5"],
                            "filter_by_difficulty": []},
                "SAMPLE_GROUPS": ["Vehicle:15", "Pedestrian:10", "Cyclist:10"],
                "NUM_POINT_FEATURES": 5, "REMOVE_EXTRA_WIDTH": [0.0, 0.0, 0.0],
                "LIMIT_WHOLE_SCENE": True,
            },
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        ],
    },
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity", "elongation"],
        "src_feature_list": ["x", "y", "z", "intensity", "elongation"],
    },
    "DATA_PROCESSOR": [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": True}},
        {"NAME": "sample_points", "NUM_POINTS": {"train": WAYMO_NUM_POINTS,
                                                 "test": WAYMO_NUM_POINTS}},
    ],
}

CBGS_CLASS_NAMES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                    "motorcycle", "bicycle", "pedestrian", "traffic_cone"]
CBGS_POINT_CLOUD_RANGE = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
CBGS_NUM_POINT_FEATURES = 5  # x, y, z, intensity, time lag


def _cbgs_anchors(stride: int):
    cfgs = [("car", [4.63, 1.97, 1.74], -0.95, 0.6, 0.45),
            ("truck", [6.93, 2.51, 2.84], -0.6, 0.55, 0.4),
            ("construction_vehicle", [6.37, 2.85, 3.19], -0.225, 0.5, 0.35),
            ("bus", [10.5, 2.94, 3.47], -0.085, 0.55, 0.4),
            ("trailer", [12.29, 2.90, 3.87], 0.115, 0.5, 0.35),
            ("barrier", [0.50, 2.53, 0.98], -1.33, 0.55, 0.4),
            ("motorcycle", [2.11, 0.77, 1.47], -1.085, 0.5, 0.3),
            ("bicycle", [1.70, 0.60, 1.28], -1.18, 0.5, 0.35),
            ("pedestrian", [0.73, 0.67, 1.77], -0.935, 0.6, 0.4),
            ("traffic_cone", [0.41, 0.41, 1.07], -1.285, 0.6, 0.4)]
    return [{"class_name": name, "anchor_sizes": [size], "anchor_rotations": [0, 1.57],
             "anchor_bottom_heights": [bottom], "align_center": False,
             "feature_map_stride": stride, "matched_threshold": matched,
             "unmatched_threshold": unmatched} for name, size, bottom, matched, unmatched in cfgs]


def _cbgs_dense_head(stride: int):
    return {
        "NAME": "AnchorHeadMulti", "CLASS_AGNOSTIC": False, "DIR_OFFSET": 0.78539,
        "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2, "USE_DIRECTION_CLASSIFIER": True,
        "SHARED_CONV_NUM_FILTER": 64, "NUM_MIDDLE_CONV": 1, "NUM_MIDDLE_FILTER": 64,
        "ANCHOR_GENERATOR_CONFIG": _cbgs_anchors(stride),
        "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": names} for names in (
            ["car"], ["truck", "construction_vehicle"], ["bus", "trailer"], ["barrier"],
            ["motorcycle", "bicycle"], ["pedestrian", "traffic_cone"])],
        "TARGET_ASSIGNER_CONFIG": {
            "NAME": "AxisAlignedTargetAssigner", "BOX_CODER": "ResidualCoder",
            "BOX_CODER_CONFIG": {"code_size": 9, "encode_angle_by_sincos": True},
        },
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 0.25, "dir_weight": 0.2,
                                         "code_weights": [1.0] * 8 + [0.2, 0.2]}},
    }


_CBGS_POST = {
    "RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1, "OUTPUT_RAW_SCORE": False,
    "EVAL_METRIC": "kitti",
    "NMS_CONFIG": {"MULTI_CLASSES_NMS": True, "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.2,
                   "NMS_PRE_MAXSIZE": 1000, "NMS_POST_MAXSIZE": 83},
}
CBGS_SECOND_MULTIHEAD = {
    "NAME": "SECONDNet", "VFE": {"NAME": "MeanVFE"}, "BACKBONE_3D": {"NAME": "VoxelResBackBone8x"},
    "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
    "BACKBONE_2D": SECOND_DYNAMIC_OBJ["BACKBONE_2D"],
    "DENSE_HEAD": _cbgs_dense_head(8), "POST_PROCESSING": _CBGS_POST,
}
CBGS_PP_MULTIHEAD = {
    "NAME": "PointPillar",
    "VFE": {"NAME": "PillarVFE", "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
            "NUM_FILTERS": [64]},
    "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 64},
    "BACKBONE_2D": {**POINTPILLAR_DYNAMIC_OBJ["BACKBONE_2D"], "UPSAMPLE_STRIDES": [0.5, 1, 2]},
    "DENSE_HEAD": _cbgs_dense_head(4), "POST_PROCESSING": _CBGS_POST,
}


def _cbgs_full(model, voxel_size, grid_size):
    import copy

    return {"CLASS_NAMES": list(CBGS_CLASS_NAMES),
            "DATA_CONFIG": {**copy.deepcopy(NUSCENES_DATASET_BASE),
                            "POINT_CLOUD_RANGE": list(CBGS_POINT_CLOUD_RANGE),
                            "VOXEL_SIZE": voxel_size, "GRID_SIZE": grid_size},
            "MODEL": model,
            "OPTIMIZATION": {**POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION, "BATCH_SIZE_PER_GPU": 4,
                             "NUM_EPOCHS": 20, "LR": 0.001}}


CBGS_CONFIGS = {  # file stem under configs/models/nuscenes_models → the whole file
    "cbgs_second_multihead": _cbgs_full(CBGS_SECOND_MULTIHEAD, [0.1, 0.1, 0.2], [1024, 1024, 40]),
    "cbgs_pp_multihead": _cbgs_full(CBGS_PP_MULTIHEAD, [0.2, 0.2, 8.0], [512, 512, 1]),
}
CBGS_GEOMETRY = {  # (VOXEL_SIZE, GRID_SIZE) of each file's DATA_CONFIG
    stem: (full["DATA_CONFIG"]["VOXEL_SIZE"], full["DATA_CONFIG"]["GRID_SIZE"])
    for stem, full in CBGS_CONFIGS.items()
}

WAYMO_CLASS_NAMES = ["Vehicle", "Pedestrian", "Cyclist"]


def _waymo_anchors():
    """Waymo's anchor configs, in CLASS_NAMES order, on the ground (z 0)."""
    cfgs = [("Vehicle", [4.7, 2.1, 1.7], 0.55, 0.4), ("Pedestrian", [0.91, 0.86, 1.73], 0.5, 0.35),
            ("Cyclist", [1.78, 0.84, 1.78], 0.5, 0.35)]
    return [{"class_name": name, "anchor_sizes": [size], "anchor_rotations": [0, 1.57],
             "anchor_bottom_heights": [0], "align_center": False, "feature_map_stride": 8,
             "matched_threshold": matched, "unmatched_threshold": unmatched}
            for name, size, matched, unmatched in cfgs]


def _waymo_data_config():
    import copy

    data = copy.deepcopy(WAYMO_DATASET_BASE)
    data["DATA_PROCESSOR"] = [
        {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
        {"NAME": "sample_points", "NUM_POINTS": {"train": WAYMO_NUM_POINTS,
                                                 "test": WAYMO_NUM_POINTS}},
        {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
        {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.1, 0.1, 0.15],
         "MAX_POINTS_PER_VOXEL": 5, "MAX_NUMBER_OF_VOXELS": {"train": 80000, "test": 90000}},
    ]
    return data


def _waymo_full(model, optimization):
    return {"CLASS_NAMES": list(WAYMO_CLASS_NAMES), "DATA_CONFIG": _waymo_data_config(),
            "MODEL": _with_anchors(model, _waymo_anchors()),
            "OPTIMIZATION": {**optimization, "NUM_EPOCHS": 30}}


_WAYMO_SECOND_HEAD = SECOND_DYNAMIC_OBJ["DENSE_HEAD"]
WAYMO_CONFIGS = {  # file stem under configs/models/waymo_models → the whole file
    "pv_rcnn": _waymo_full(PV_RCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION),
    "second": _waymo_full({
        **SECOND_DYNAMIC_OBJ,
        "DENSE_HEAD": {**_WAYMO_SECOND_HEAD, "TARGET_ASSIGNER_CONFIG": {
            k: _WAYMO_SECOND_HEAD["TARGET_ASSIGNER_CONFIG"][k] for k in ("NAME", "BOX_CODER")}},
        "POST_PROCESSING": {**SECOND_DYNAMIC_OBJ["POST_PROCESSING"], "NMS_CONFIG": {
            **SECOND_DYNAMIC_OBJ["POST_PROCESSING"]["NMS_CONFIG"], "NMS_THRESH": 0.7}},
    }, GRID_OPTIMIZATION),
    "PartA2": _waymo_full(PART_A2_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION),
}

# the YAML files (relative to the repository root) that ship as the dicts above
SHIPPED_MODEL_CONFIGS = {
    "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml": POINTRCNN_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/pointpillar_dynamic_obj.yaml": POINTPILLAR_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/second_dynamic_obj.yaml": SECOND_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml": PV_RCNN_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/second_iou_dynamic_obj.yaml": SECOND_IOU_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/voxel_rcnn_dynamic_obj.yaml": VOXEL_RCNN_DYNAMIC_OBJ_FULL,
    "configs/models/lyft_models/part_a2_dynamic_obj.yaml": PART_A2_DYNAMIC_OBJ_FULL,
    "configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml":
        NUSCENES_BOSTON_POINTRCNN_DYNAMIC_OBJ_FULL,
    **{f"configs/models/kitti_models/{stem}.yaml": full for stem, full in KITTI_CONFIGS.items()},
    **{f"configs/models/nuscenes_models/{stem}.yaml": full for stem, full in CBGS_CONFIGS.items()},
    **{f"configs/models/waymo_models/{stem}.yaml": full for stem, full in WAYMO_CONFIGS.items()},
}


# ---------------------------------------------------------------------------
# Label-free pipeline configs: ``configs/pipeline/<name>.yaml`` and its
# ``data_paths`` group, as PyYAML parses them (``${...}`` interpolations are
# left in place and resolved by ``cli/common.py::load_pipeline_config``, the
# way ``modest_tpu/utils/config.py::resolve_interpolations`` does). A test
# holds each dict equal to its YAML file.
# ---------------------------------------------------------------------------

PIPELINE_PP_SCORE = {
    "data_paths": "fw70_2m",
    "work_dir": ".",
    "total_part": 1,
    "part": 0,
    "seed": 1024,
    "max_neighbor_dist": 0.3,
    "remove_ground_plane": False,
    "limit_traversals": -1,
    "data_root": "???",
    "nusc": False,
    "add_random_noise": 0,
    "skip_ephe": False,
    "ephe_type": "entropy",
}

PIPELINE_GENERATE_MASK = {
    "data_paths": "fw70_2m",
    "work_dir": ".",
    "total_part": 1,
    "part": 0,
    "data_root": "???",
    "calib_path": "${data_root}/calib",
    "ptc_path": "${data_root}/velodyne",
    "plane_estimate": {"range": [[-70, 70], [-20, 20]], "max_hs": -1.5, "offset": 0.05},
    "limit_range": [[-70, 70], [-40, 40]],
    "graph": {"neighbor_type": "radius_mutual_knn", "affinity_type": "l1",
              "n_neighbors": 70, "radius": 2.0},
    "clustering": {"method": "DBSCAN", "DBSCAN": {"eps": 0.1, "min_samples": 10}},
    "filtering": {"min_points": 10, "max_volume": 120, "min_volume": 0.5,
                  "min_max_height": 0.5, "max_min_height": 1.0, "percentile": 20,
                  "min_percentile_pp_score": 0.7},
    "bbox_gen": {"fit_method": "closeness_to_edge"},
}


def _data_paths(dataset: str, name: str, pp: str, seg: str, bbox: str, labels: str):
    meta = "${work_dir}/meta_data/" + dataset
    out = "${work_dir}/intermediate_results/"
    return {
        "track_path": f"{meta}/{name[0]}",
        "idx_info": f"{meta}/{name[1]}",
        "load_precomputed_lidars": None,
        "load_save_precomputed_trans_mat": None,
        "idx_list": f"{meta}/{name[2]}",
        "pp_score_path": out + pp,
        "seg_save_dst": out + seg,
        "bbox_info_save_dst": out + bbox,
        "label_file_save_dst": out + labels,
    }


PIPELINE_DATA_PATHS = {
    "fw70_2m": _data_paths(
        "lyft", ("fw70_2m_train_track_list.pkl", "fw70_2m_valid_train_idx_info.pkl",
                 "fw70_2m_train_idx.txt"),
        "lyft_pp_score_fw70_2m_r0.3", "lyft_seg_pp_score_fw70_2m_r0.3/",
        "lyft_bbox_pp_score_fw70_2m_r0.3/", "lyft_labels_pp_score_fw70_2m_r0.3_fov/"),
    "nusc": _data_paths(
        "nuscenes", ("track_list.pkl", "valid_idx_info.pkl", "train_idx.txt"),
        "nusc_pp_score_fw_30_r0.3/", "nusc_seg_pp_score_fw_30_r0.3/",
        "nusc_bbox_pp_score_fw_30_r0.3/", "nusc_labels_pp_score_fw_30_r0.3_fov/"),
}

PIPELINE_GENERATE_LABEL_FILES = {
    "data_paths": "fw70_2m",
    "work_dir": ".",
    "total_part": 1,
    "part": 0,
    "data_root": "???",
    "calib_path": "${data_root}/calib",
    "ptc_path": "${data_root}/velodyne",
    "image_shape": [1024, 1224],
    "fov_only": True,
    "nms": {"enable": True, "threshold": 0.1},
}

PIPELINE_COMBINE_LABELS = {
    "data_paths": "fw70_2m",
    "work_dir": ".",
    "total_part": 1,
    "part": 0,
    "data_root": "???",
    "calib_path": "${data_root}/calib",
    "ptc_path": "${data_root}/velodyne",
    "det_result_path": None,
    "save_path": None,
    "image_shape": [1024, 1224],
    "fov_only": True,
    "det_filtering": {"pp_score_percentile": 50, "pp_score_threshold": 0.5,
                      "score_filtering": -1},
    "nms": {"enable": True, "threshold": 0.1},
    "with_score": False,
}

PIPELINE_CONFIGS = {"pp_score": PIPELINE_PP_SCORE, "generate_mask": PIPELINE_GENERATE_MASK,
                    "generate_label_files": PIPELINE_GENERATE_LABEL_FILES,
                    "combine_labels": PIPELINE_COMBINE_LABELS}

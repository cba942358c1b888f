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
``configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml`` whole. ``PIPELINE_*`` are
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

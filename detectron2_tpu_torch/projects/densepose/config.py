"""DensePose config keys (counterpart of
``detectron2_tpu/projects/densepose/config.py``): every key of the JAX
package's ``add_densepose_config``, the CSE, HRNet, evaluation and bootstrap
keys included, with the same values, so that every DensePose yaml merges,
and the bootstrap's per-dataset schema (``get_bootstrap_dataset_config``,
``load_bootstrap_config``, JAX :36-74).
``DENSEPOSE_EVALUATION.EVALUATE_MESH_ALIGNMENT`` is read by neither package
(ROADMAP C). ``BOOTSTRAP_MODEL.DEVICE`` is ``"cuda"`` here (the JAX
package's is ``"tpu"``): the bootstrap model runs on ``MODEL.DEVICE``, as
in the JAX package, which reads neither."""

from detectron2_tpu_torch.config.cfg_node import CfgNode as CN


def add_evaluation_config(cfg):
    """(reference config.py:22-47)."""
    cfg.DENSEPOSE_EVALUATION = CN()
    # "iou": bbox-IoU matching; "cse": GPS matching via embeddings
    cfg.DENSEPOSE_EVALUATION.TYPE = "iou"
    # storage for multi-process evaluation intermediates
    cfg.DENSEPOSE_EVALUATION.STORAGE = "none"
    # lower threshold -> more matches -> higher AP
    cfg.DENSEPOSE_EVALUATION.MIN_IOU_THRESHOLD = 0.5
    cfg.DENSEPOSE_EVALUATION.DISTRIBUTED_INFERENCE = True
    # mesh-alignment eval on vertex embeddings (CSE only)
    cfg.DENSEPOSE_EVALUATION.EVALUATE_MESH_ALIGNMENT = False
    cfg.DENSEPOSE_EVALUATION.MESH_ALIGNMENT_MESH_NAMES = []


def add_bootstrap_config(cfg):
    """(reference config.py:50-56)."""
    cfg.BOOTSTRAP_DATASETS = []
    cfg.BOOTSTRAP_MODEL = CN()
    cfg.BOOTSTRAP_MODEL.WEIGHTS = ""
    cfg.BOOTSTRAP_MODEL.DEVICE = "cuda"


def get_bootstrap_dataset_config() -> CN:
    """The schema of one ``BOOTSTRAP_DATASETS`` entry, with d2's defaults."""
    _C = CN()
    _C.DATASET = ""
    # the share of this loader in the mix (the ground truth's is 1)
    _C.RATIO = 0.1
    _C.IMAGE_LOADER = CN(new_allowed=True)
    _C.IMAGE_LOADER.TYPE = ""
    _C.IMAGE_LOADER.BATCH_SIZE = 4
    _C.IMAGE_LOADER.NUM_WORKERS = 4
    _C.IMAGE_LOADER.CATEGORIES = []
    _C.IMAGE_LOADER.MAX_COUNT_PER_CATEGORY = 1_000_000
    _C.IMAGE_LOADER.CATEGORY_TO_CLASS_MAPPING = CN(new_allowed=True)
    _C.INFERENCE = CN()
    _C.INFERENCE.INPUT_BATCH_SIZE = 4
    _C.INFERENCE.OUTPUT_BATCH_SIZE = 2
    _C.DATA_SAMPLER = CN(new_allowed=True)
    _C.DATA_SAMPLER.TYPE = ""
    _C.DATA_SAMPLER.USE_GROUND_TRUTH_CATEGORIES = False
    _C.FILTER = CN(new_allowed=True)
    _C.FILTER.TYPE = ""
    return _C


def load_bootstrap_config(cfg) -> None:
    """Each ``BOOTSTRAP_DATASETS`` entry (a dict from the yaml) made a full
    node: merged over :func:`get_bootstrap_dataset_config`."""
    if not cfg.BOOTSTRAP_DATASETS:
        return
    nodes = []
    for dataset_cfg in cfg.BOOTSTRAP_DATASETS:
        _C = get_bootstrap_dataset_config().clone()
        _C.merge_from_other_cfg(CN(dict(dataset_cfg)))
        nodes.append(_C)
    cfg.BOOTSTRAP_DATASETS = nodes


def add_dataset_category_config(cfg):
    """Category-merging options for class-agnostic / multi-dataset training
    (reference config.py:8-18)."""
    cfg.DATASETS.CATEGORY_MAPS = CN(new_allowed=True)
    cfg.DATASETS.WHITELISTED_CATEGORIES = CN(new_allowed=True)
    # class id -> mesh name mapping for CSE
    cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING = CN(new_allowed=True)


def add_densepose_config(cfg):
    """Add config for the DensePose head (chart + CSE) plus the bootstrap /
    category / evaluation blocks (reference config.py:272-277)."""
    add_bootstrap_config(cfg)
    add_dataset_category_config(cfg)
    add_evaluation_config(cfg)
    cfg.MODEL.ROI_HEADS.NAME = "DensePoseROIHeads"
    cfg.MODEL.DENSEPOSE_ON = True

    cfg.MODEL.ROI_DENSEPOSE_HEAD = CN()
    cfg.MODEL.ROI_DENSEPOSE_HEAD.NAME = "DensePoseV1ConvXHead"
    cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_STACKED_CONVS = 8
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_DIM = 512
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CONV_HEAD_KERNEL = 3
    # 24 body parts + background for the index head
    cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_PATCHES = 24
    # predictor deconv kernel + post-deconv bilinear upscale factor
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECONV_KERNEL = 4
    cfg.MODEL.ROI_DENSEPOSE_HEAD.UP_SCALE = 2
    # 2 (fg/bg) or 15 (14 body parts + background) coarse channels
    cfg.MODEL.ROI_DENSEPOSE_HEAD.NUM_COARSE_SEGM_CHANNELS = 2
    # train the coarse segmentation against rasterized GT masks instead of at
    # the annotated dp points (reference config.py:90, losses/mask_or_segm.py;
    # the animal CSE configs where dp coarse-segm annotations are absent)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.COARSE_SEGM_TRAINED_BY_MASKS = False
    cfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_TYPE = "ROIAlignV2"
    cfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_RESOLUTION = 28
    cfg.MODEL.ROI_DENSEPOSE_HEAD.POOLER_SAMPLING_RATIO = 2
    cfg.MODEL.ROI_DENSEPOSE_HEAD.HEATMAP_SIZE = 112
    cfg.MODEL.ROI_DENSEPOSE_HEAD.INDEX_WEIGHTS = 5.0
    cfg.MODEL.ROI_DENSEPOSE_HEAD.PART_WEIGHTS = 1.0
    cfg.MODEL.ROI_DENSEPOSE_HEAD.POINT_REGRESSION_WEIGHTS = 0.01
    cfg.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME = "DensePoseChartWithConfidencePredictor"
    # attach raw coarse/fine/u/v predictor maps at inference (the bootstrap
    # pipeline's samplers consume these)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.RAW_OUTPUTS = False
    # the dp conv stack runs only on the top-K score-sorted
    # detection slots at inference (the DensePose metric scores maxDets=20,
    # so 24 is metric-lossless vs the 100 padded slots); 0 = every slot
    cfg.MODEL.ROI_DENSEPOSE_HEAD.MAX_INFERENCE_INSTANCES = 24
    # (padded form of the reference DensePoseDataFilter): the dp
    # branch trains only on up to this many slots with IoU>=FG_IOU_THRESHOLD
    # against a dp-annotated gt; 0 = the generic 128-slot fg budget
    cfg.MODEL.ROI_DENSEPOSE_HEAD.MAX_TRAIN_INSTANCES = 32
    # reference densepose/config.py:181
    cfg.MODEL.ROI_DENSEPOSE_HEAD.FG_IOU_THRESHOLD = 0.7
    # loss family selector (reference config.py; dispatched by PREDICTOR_NAME
    # here — chart losses for chart predictors, CSE losses for embedding ones)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.LOSS_NAME = "DensePoseChartWithConfidenceLoss"
    # FPN decoder ahead of the densepose pooler (ON in the zoo configs)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON = True
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NUM_CLASSES = 256
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_CONV_DIMS = 256
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_NORM = ""
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_COMMON_STRIDE = 4

    # DeepLab head variant (reference roi_heads/deeplab.py)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB = CN()
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NORM = "GN"
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DEEPLAB.NONLOCAL_ON = 0

    # UV confidence modeling (reference config.py add_densepose_head_config:
    # optional UV-symmetry table pickle for hflip augmentation (the official
    # UV_symmetry_transforms data; empty = identity UV on flip)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_SYMMETRY_PATH = ""
    # UV_CONFIDENCE; Neverova et al. NeurIPS 2019)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE = CN({"ENABLED": False})
    cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.TYPE = "iid_iso"  # iid_iso | indep_aniso
    cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.EPSILON = 0.01
    # segmentation confidence (the *M model variants; reference config.py:221)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.SEGM_CONFIDENCE = CN({"ENABLED": False})
    cfg.MODEL.ROI_DENSEPOSE_HEAD.SEGM_CONFIDENCE.EPSILON = 0.01

    # HRNet backbone (reference config.py add_hrnet_config — HigherHRNet w32)
    cfg.MODEL.HRNET = CN()
    cfg.MODEL.HRNET.STEM_INPLANES = 64
    for name, (mods, branches, blocks, chans) in {
        "STAGE2": (1, 2, [4, 4], [32, 64]),
        "STAGE3": (4, 3, [4, 4, 4], [32, 64, 128]),
        "STAGE4": (3, 4, [4, 4, 4, 4], [32, 64, 128, 256]),
    }.items():
        stage = CN()
        stage.NUM_MODULES = mods
        stage.NUM_BRANCHES = branches
        stage.BLOCK = "BASIC"
        stage.NUM_BLOCKS = blocks
        stage.NUM_CHANNELS = chans
        stage.FUSE_METHOD = "SUM"
        setattr(cfg.MODEL.HRNET, name, stage)
    cfg.MODEL.HRNET.HRFPN = CN()
    cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS = 256

    # Continuous Surface Embeddings (reference config.py add_densepose_head_cse_config)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE = CN()
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_SIZE = 16
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_LOSS_WEIGHT = 0.6
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_LOSS_NAME = "EmbeddingLoss"
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDING_DIST_GAUSS_SIGMA = 0.01
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.GEODESIC_DIST_GAUSS_SIGMA = 0.01
    # per-mesh embedder specs, reference dict layout (TYPE/NUM_VERTICES/
    # FEATURE_DIM/FEATURES_TRAINABLE/IS_TRAINABLE/INIT_FILE subspecs,
    # reference config.py:114 CN(new_allowed=True)). The legacy list-of-pairs
    # layout [["smpl_27554", 27554]] is also accepted when assigned
    # programmatically. Empty (the default) means no embedder.
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS = CN(new_allowed=True)

    # shape-to-shape cycle-consistency loss (the m2m "evolution" configs;
    # reference config.py:130-140)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS = CN({"ENABLED": False})
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.WEIGHT = 0.025
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.NORM_P = 2
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.TEMPERATURE = 0.05
    # vertex subsample size per mesh (<=0: all vertices)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.MAX_NUM_VERTICES = 4936

    # pixel-to-shape cycle-consistency loss (the i2m "evolution" configs;
    # reference config.py:141-155)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS = CN({"ENABLED": False})
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.WEIGHT = 0.0001
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.NORM_P = 2
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.USE_ALL_MESHES_NOT_GT_ONLY = False
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.NUM_PIXELS_TO_SAMPLE = 100
    # kept for config parity: the reference reads PIXEL_SIGMA but its forward
    # never uses it (cycle_pix2shape.py:66 vs 122-145)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.PIXEL_SIGMA = 5.0
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.TEMPERATURE_PIXEL_TO_VERTEX = 0.05
    cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.PIX_TO_SHAPE_CYCLE_LOSS.TEMPERATURE_VERTEX_TO_PIXEL = 0.05


def is_cse(cfg) -> bool:
    """Whether ``cfg`` builds a CSE DensePose model (the embedding
    predictor): the one test of the heads and the trainer's evaluator."""
    return cfg.MODEL.DENSEPOSE_ON and cfg.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME == "DensePoseEmbeddingPredictor"

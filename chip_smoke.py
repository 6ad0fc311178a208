#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one GPU
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns: R50 forward, train step, ViTDet forward,
                                     # the forwards of phases 14-16, one train step of each of phases 19-21,
                                     # and one RoIAlign backward call per timed pool
    python3 chip_smoke.py --ptxas --kernels-only  # while working on a kernel: registers, spills and the
                                     # compiler's warnings per kernel, then phases 3, 8, 6 and 18 alone
    python3 chip_smoke.py --gate-determinism  # phases 1-2, then where the gate's runs stop being
                                     # reproducible: 100 steps twice under each determinism setting
    python3 chip_smoke.py --lvis-voc-only  # phases 1-2 and 29-31 (LVIS, ViTDet-B LVIS, Pascal VOC) alone
    python3 chip_smoke.py --seg-only  # phases 1-2 and 32-33 (PanopticFPN, SemanticSegmentor) alone
    python3 chip_smoke.py --rcnn-options-only  # phases 1-2 and 34-35 (Fast R-CNN, GIoU, pred boxes, Cityscapes) alone
    python3 chip_smoke.py --backbones-only  # phases 1-2 and 36-38 (MViTv2, Swin, RegNet) alone
    python3 chip_smoke.py --dconv-densepose-only  # phases 1-2 and 39-40 (deformable conv, DensePose) alone
    python3 chip_smoke.py --cse-only  # phases 1-2 and 40-42 (DensePose with its evaluator, CSE) alone
    python3 chip_smoke.py --hrfpn-bootstrap-only  # phases 1-2 and 43-44 (HRFPN DensePose, bootstrap training) alone
    python3 chip_smoke.py --pointrend-only  # phases 1-2 and 45 (PointRend, PointSup) alone

Phases, in order; any failure exits non-zero:

1. card: name and power limit; TF32 off for the comparisons;
2. build: every CUDA kernel of the port, one nvcc per source, in parallel;
3. kernel vs plain: the RoIAlign kernel against its plain PyTorch version in
   float32 and bfloat16, aligned and v1 grids, sampling_ratio 0 and 2, at the
   Mask R-CNN R50-FPN main-path shapes (box pool 16000 rois at 7x7, mask pool
   1600 rois at 14x14 over p2-p5 of 16 images at 800x1344, C=256), with
   rois partly off the map, zero-area rois and padded zero rows; times the
   kernel and the plain version with CUDA events;
4. golden: the R18-FPN fixture of tests/goldens/e2e_maskrcnn_r18.npz run on
   the card in float32 must reproduce the reference detections;
5. main path: the full-width R50-FPN Mask R-CNN (3x config, bf16, masks
   pasted on the device, seeded random weights) answers 3 DefaultPredictor
   requests, then runs the batch forward at 16 x 800x1344; the kernel's
   launch count must show that both pools of every forward went through it,
   and the kernel is held once more against the plain version on the
   pooler inputs the main path produced;
6. backward kernel vs plain: the RoIAlign backward kernel against its plain
   version at the R50-FPN train shapes (box pool 4096 rois at 7x7, mask pool
   1024 rois at 14x14 over p2-p5 of 8 images at 800x1344, C=256), float32
   and bfloat16 cotangents, both grids, sampling_ratio 0 and 2; every case
   on the 16-byte path and bitwise equal over two launches; timed with CUDA
   events beside its bound and its time before the redesign;
7. training, full width: the R50-FPN Mask R-CNN (3x config, bf16, seeded
   weights) takes 10 steps of the port's SimpleTrainer with build_optimizer
   and the LRScheduler hook (warmup over 100 steps, not 1000) on a
   synthetic padded batch of 8 x 800x1344 with 5-50 valid gt per image; every loss is finite at every step, each kernel
   launches twice per step, every trainable parameter moves and the frozen
   stem and res2 do not; both kernels are held against their plain versions
   on the pooler inputs and cotangents the first step recorded (each
   cotangent scaled exactly, by a power of two, to a max in [1, 2)), the
   backward there on the 16-byte path and bitwise equal over two launches,
   and held once more on the same rois and cotangent in float32 and
   bfloat16, on both grids, at sampling ratios 0 and 2;
8. attention kernels vs plain: both entry points of csrc/flash_attention.cu
   (standard and transposed bias factors) against their plain PyTorch
   versions at the two ViTDet-B shapes, global [96, 4096, 64] with 64x64
   factors and windowed [2400, 196, 64] with 14x14, with and without bias,
   in float32 and bfloat16; timed with CUDA events beside the bound and
   beside one F.scaled_dot_product_attention call with the bias
   materialised as attn_mask (measured here only, used nowhere in the port);
   each launch must take the kernel its shape is dispatched to (float32 the
   SIMT one, bfloat16 the wgmma kernel at the global shape and the
   whole-window kernel at the windowed one);
9. ViTDet main path, full width: Mask R-CNN ViTDet-B (12 blocks of width
   768, 14x14 windows, 4 global blocks; bf16, masks pasted on the device,
   seeded random weights) runs 4 batch forwards at 8 x 1024x1024, then
   answers 3 requests of differing sizes through the predictor (resize to
   1024, pad to the square, forward, postprocess); every forward must launch
   the attention kernel 12 times (8 windowed + 4 global blocks) and the
   RoIAlign kernel twice; the kernels are held once more against their
   plain versions on the q, k, v and factors the first windowed and the
   first global block produced and on the pooler inputs; one more forward
   with the transposed factor layout (D2T_FLASH_V2=1) must launch the
   transposed kernel 12 times and detect what the standard layout detected;
   in every forward the 4 global launches must have taken the wgmma kernel
   and the 8 windowed ones the whole-window kernel, in both layouts;
10. COCO evaluation, full width (``tools/train_net.py --eval-only`` on the
   port): a synthetic COCO-format dataset of 64 PNGs at COCO's image sizes
   (written without PIL, 1-12 rectangle and polygon objects each over the
   80 categories, crowd RLE in every eighth image) registered with
   register_coco_instances; the zoo's R50-FPN 3x yaml in bf16 with phase
   5's seeded weights and FrozenBN statistics; DefaultTrainer.test with
   COCOEvaluator over the test loader. Every metric of the csv table must
   be finite and in [0, 100], the RoIAlign kernel must launch twice per
   batch (box and mask pool) on its 16-byte path, the ground truth fed back
   as detections must score AP 100 (bbox and segm), and on four images the
   eval path's Instances must equal DefaultPredictor's (classes equal,
   boxes within 1e-3 px, scores within 1e-4, masks on 99.9% of pixels).
   The RoIAlign kernel is held once more against its plain version on the
   pooler inputs of the loader's first batch, in bf16 as run and in
   float32. Logs the eval loop's img/s, its data/compute/evaluator seconds per
   image, COCOeval's wall time and the peak memory;
11. DefaultTrainer, full width (``tools/train_net.py`` training on the
   port): phase 10's 32 images registered as a train set and the first 8
   as a test set; the zoo's R50-FPN 3x yaml in bf16 with its own training
   input (16 images per batch, shortest edge drawn from 640-800, long edge
   at most 1333, horizontal flips, aspect-ratio grouping, TrainingSampler),
   MODEL.WEIGHTS the checkpoint phase 7 saved with DetectionCheckpointer
   after its 10 steps (its FrozenBN statistics calibrated again on 4 of
   these images); 6 steps (checkpoint every 3, warmup over 100 steps,
   gradients clipped to a global norm of 1, score threshold 0 at test)
   through the train loader, the hooks, the
   checkpointer and one EvalHook evaluation after training. Every loss is
   finite at every step, each step launches the RoIAlign forward and
   backward kernels twice, each eval batch the forward twice; metrics.json
   holds a line per step with the five losses, lr, data_time and (after the
   timer's warmup) time; model_0000002.pth and model_final.pth exist; every
   printed AP is finite and in [0, 100]. Both kernels are held once more
   against their plain versions on the first batch's pooler inputs and
   cotangents, in bf16 as run and in float32. A second DefaultTrainer on
   the same OUTPUT_DIR resumes from model_0000002.pth at iteration 3 with
   the model and optimizer state equal to the checkpoint's bit for bit, and
   takes one step. Logs the median step time and data time, img/s, the
   share of each step spent waiting on the loader and the peak memory;
12. the train->AP gate (``tests/test_train_to_ap.py`` of the JAX package):
   the overfit dataset (16 images of color-coded rectangles at 64x64, 3
   classes) and config (R18-FPN with GroupNorm, float32, 500 steps, LR
   stepped at 400, one evaluation after training) through DefaultTrainer:
   verify_results holds bbox AP to 96 +- 6 and segm AP to 87 +- 8, and the
   run requires bbox AP >= 90 and segm AP >= 79; the kernels launch twice a
   step (forward and backward) and twice an eval batch (forward), all on the
   16-byte path. Both kernels are held once more against their plain
   versions on the first batch's pooler inputs and cotangents (float32, as
   run: three levels p3-p5, 64 channels, 7x7 box and mask pools). Logs
   both APs and the wall time;
13. RoIAlign kernel vs plain at the shapes of the other R-CNN heads, in
   float32 and bfloat16 (timed): the C4 box pool (16000 rois, 14x14, one
   level, res4 of 16 x 800x1344 at 1024 channels) and mask pool (1600
   rois), also on the v1 grid at sampling ratio 2; the keypoint pool (1600
   rois, 14x14 over p2-p5) and a cascade stage's box pool (16000 rois, 7x7);
   every case on the 16-byte path;
14. Keypoint R-CNN R50-FPN 3x (``configs/COCO-Keypoints/
   keypoint_rcnn_R_50_FPN_3x.yaml`` through ``model_zoo.get_config``, bf16,
   seeded weights, SCORE_THRESH_TEST 0 so that every image keeps its 100
   detections): DefaultPredictor on one 480x640 image (first and steady
   call: boxes, 17 keypoints each inside the image, probabilities in (0,
   1]), then one batch forward at 16 x 800x1344 that records the pools and
   3 timed ones (median and range, peak memory, the NMS loop's rounds),
   and one more with each NMS call timed between two synchronisations;
   the kernel launches twice per forward (box, keypoint) on its 16-byte
   path and is held to its plain version on the recorded pools; then
   ``DefaultTrainer.test`` (``train_net --eval-only``) over 24 synthetic
   person-keypoint COCO images (``write_synthetic_coco(keypoints=True)``):
   bbox and keypoints AP finite, two launches per batch, and AP 100 (bbox
   and keypoints) for the ground truth fed back;
15. Mask R-CNN R50-C4 3x (``mask_rcnn_R_50_C4_3x.yaml``): as phase 14,
   with the box pool and the mask pool on res4 (1024 channels) and res5
   run in the heads over 16000 rois;
16. Cascade Mask R-CNN R50-FPN 3x (``Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml``):
   as phase 14, with 4 launches per forward (3 box stages, mask);
17. test-time augmentation: GeneralizedRCNNWithTTA over the zoo R50-FPN 3x
   with phase 5's weights (bf16, SCORE_THRESH_TEST 0) on 1 of phase 10's
   images with the config's TEST.AUG (shortest edge 400-1200 in 9 sizes,
   each flipped): 3 launches per copy (box and mask pools, and the mask
   pool on the merged boxes), the pools of the first copy held to the
   plain version; with one size (800) and no flip, TTA equals
   DefaultPredictor on the same image (``instances_agree``);
18. RoIAlign forward and backward kernels vs plain at the shapes the
   heads' train steps give them, 16 images a step: the C4 res4 pool (8192
   rois, 14x14, one level of 16 x 50x84 x 1024), the keypoint pool (2048
   rois, 14x14 over p2-p5, C=256), a cascade box pool (8192 rois, 7x7) and
   the mask pool (2048 rois, 14x14); float32 and bfloat16, both grids,
   sampling ratio 0 and 2; every case on the 16-byte path, the backward
   bitwise equal over two launches; bf16 aligned s=0 timed beside the
   bounds (``roi_align_cost`` / ``roi_align_backward_cost``);
19. Keypoint R-CNN R50-FPN 3x training (``tools/train_net.py`` on the
   port): the zoo yaml through ``model_zoo.get_config``, bf16, at its own
   training input (16 images a step, 640-800 / 1333, flips with the COCO
   person keypoint flip map, POST_NMS_TOPK_TRAIN 1500) on 64 synthetic
   person keypoint images registered with the keypoint names and flip map
   (their first 16 the test set); seeded weights with FrozenBN calibrated
   on 4 train images, 5 DefaultTrainer steps (warmup over 100, gradients
   clipped to a global norm of 1) and one EvalHook evaluation: every loss
   finite at every step (``loss_keypoint`` included), B1 and B2 launched
   twice a step (box, keypoint) and B1 twice an eval batch, every trainable
   tensor of the keypoint head moved, both kernels held to their plain
   versions on the first batch's pools and cotangents (bf16 as run and
   float32), bbox and keypoints AP finite and in [0, 100]; logs the
   phase's seconds, the median step time and data_time, img/s, the
   loader's share and the peak memory;
20. Mask R-CNN R50-C4 3x training (``mask_rcnn_R_50_C4_3x.yaml``), as
   phase 19 on phase 10's images: B1 and B2 launch once a step (the res4
   pool of the 8192 sampled rois at 1024 channels; the mask loss reads its
   foreground rows of res5's output), B1 twice an eval batch;
21. Cascade Mask R-CNN R50-FPN 3x training
   (``Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml``), as phase 20: 4 B1 and 4
   B2 launches a step (3 box stages, their cotangents scaled by 1/3, and
   the mask pool), the six stage losses logged separately;
22. the keypoint train->AP gate (``tests/test_train_to_ap.py:170-226`` of
   the JAX package): ``testing.overfit_keypoint_config`` on
   ``write_synthetic_overfit_coco(keypoints=True)`` (corner keypoints), 500
   steps in float32 through DefaultTrainer: verify_results holds bbox AP
   to 75 +- 25 and keypoints AP to 60 +- 40, and the run requires
   keypoints AP >= 20; the kernels launch 2 + 2 times a step and B1 twice
   an eval batch; both held to their plain versions on the first batch;
23. ViTDet-B training from ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py``
   as it is, through ``detectron2_tpu_torch.tools.lazyconfig_train_net``
   (LazyConfig, instantiate, LSJ onto 1024x1024 with flips and boxes
   recomputed from the cropped polygons, RGB, DropPath 0.1, the layer-wise
   AdamW of its ``make_optimizer`` and its warmup schedule, bf16) on phase
   10's PNGs registered by ``--dataset``; cuts: 8 images a step, 4 steps,
   a checkpoint every 2, ``do_test`` over 8 images after training, seeded
   weights: every loss finite at every step, parameters moved in the ViT
   blocks, the SimpleFeaturePyramid and the heads, DropPath dropped, B3
   launched 4 (``wgmma``) + 8 (``mma_window``) times a step and B1/B2 twice
   (16-byte path), B1/B2 held to their plain versions on the first batch's
   pools, B3 on a global and a windowed block's recorded q/k/v and the
   kernel-forward attention's gradient to the plain function's autograd
   there, a resume from the first checkpoint; logs the median step and
   data_time, the loader's share, the peak memory, and the attention
   backward's device time (CUDA events around each call) in a step and its
   share of a fixed batch's step;
24. Mask R-CNN R50-FPN trained from scratch from
   ``configs/new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py`` as it is,
   through ``lazyconfig_train_net``: SyncBN (batch statistics over the
   card's whole batch) in every conv of the ResNet, the FPN, the 4conv1fc
   box head and the 4-conv mask head, FREEZE_AT 0, a 2-conv RPN head, LSJ
   0.1-2.0 onto 1024x1024 with flips, SGD at the recipe's LR 0.1 and weight
   decay 4e-5 with its warmup, bf16, on phase 10's PNGs; cuts: 32 images a
   step (the recipe's 64 over 8 cards), 4 steps, a checkpoint every 2, the
   evaluation over 8 images: every loss finite, every BN's running
   statistics moved from 0 / 1, parameters moved in the stem, res5, the FPN
   and both heads, B1/B2 twice a step and held to their plain versions on
   the first batch, a resume from step 2 restoring parameters, momentum
   and running statistics exactly, finite AP with the running statistics;
   logs step ms, the loader's share, peak memory, and the BN passes' device
   time in one profiled step against the RPN's NMS and the cuDNN/cuBLAS
   kernels';
25. DefaultTrainer on ``configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml``
   (seeded weights; 16 images at the yaml's input, 4 steps,
   ``TEST.PRECISE_BN.NUM_ITER`` 4): the PreciseBN hook runs after the last
   step and writes, into every BN, the mean over its 4 batches of the
   batch statistics recomputed in float64; the frozen stem and res2 keep
   their parameters while their BNs update their running statistics; B1/B2
   twice a step, held to their plain versions; finite AP.
26. RetinaNet R50-FPN 3x (``configs/COCO-Detection/retinanet_R_50_FPN_3x.yaml``
   as it is, 9 anchors a location; bf16, seeded weights):
   DefaultPredictor on one image and the 16 x 800x1344 batch at
   SCORE_THRESH_TEST 0 (5 x 1000 candidates an image into the NMS), every
   box finite and inside the image after postprocess, at most 100 an image;
   DefaultTrainer at the yaml's input (16 images, 640-800 / 1333, flips),
   6 steps, a checkpoint at 3, a resume restoring the parameters, the
   momentum and ``loss_normalizer`` bitwise, finite AP over 8 images; one
   profiled batch forward and one profiled train step split by part
   (backbone + FPN, head, matching, focal loss, box loss, top-k, NMS);
27. FCOS R50-FPN from ``configs/COCO-Detection/fcos_R_50_FPN_1x.py``
   through LazyConfig/instantiate, with the dataloader, optimizer and LR
   schedule of ``retinanet_R_50_FPN_1x.py`` (``--recipe-from``): inference
   at 16 x 800x1344 at its threshold 0.2 and at 0; 4 steps through
   ``lazyconfig_train_net`` (finite losses, parameters moved in
   the GN head, P6/P7 and res5), finite AP; profiled as phase 26;
28. the RPN-only model: ``rpn_R_50_FPN_1x.yaml`` through DefaultTrainer, 4
   steps, then ``DefaultTrainer.test`` with finite AR@100 and AR@1000;
   ``rpn_R_50_C4_1x.yaml``, one 16 x 800x1344 batch (12000 pre-NMS boxes),
   its NMS's rounds and ms.
   No RoIAlign and no attention run in phases 26-28: B1-B4 must launch 0
   times there.
29. LVIS v1: ``configs/LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml``
   as it is (1203 classes, SCORE_THRESH_TEST 1e-4, 300 detections an
   image): the 16 x 800x1344 batch forward with the masks pasted on the
   device (peak memory, the NMS's rounds and ms), DefaultTrainer at the
   yaml's input with RepeatFactorTrainingSampler at 0.001 on a synthetic
   LVIS (``testing.write_synthetic_lvis``; some repeat factors above 1),
   4 steps, its EvalHook through ``tools/train_net.py``'s
   ``build_evaluator`` (LVISEvaluator: AP, APr/APc/APf finite, COCOeval's
   seconds), the ground truth fed back at AP 100; B1 twice a forward and a
   step, B2 twice a step, held on the recorded pools and cotangents;
30. ViTDet-B on LVIS from ``configs/ViTDet/LVIS/mask_rcnn_vitdet_b_100ep.py``
   as it is (sigmoid CE and the federated loss over 1203 classes, weights
   from ``lvis_v1_train``'s builtin metadata) through
   ``lazyconfig_train_net``, 4 steps at 8 x 1024x1024 on phase 29's data
   (each step's fed-loss mask must keep the appeared foreground classes
   plus ``max(50 - n_appeared, 0)`` drawn ones, the background counted),
   LVISEvaluator over 8 images; B1/B2 twice and B3 12 times a step, held
   on the first step's inputs and cotangents; then one batch forward of
   ``cascade_mask_rcnn_vitdet_b_100ep.py`` whose three stages' probabilities
   must be sigmoids, B1 held on its four pools;
31. Pascal VOC: ``faster_rcnn_R_50_FPN.yaml`` through DefaultTrainer, 4
   steps at 16 images (480-800 / 1333) from a synthetic VOC 2007 + 2012
   trainval (``testing.write_synthetic_voc``), PascalVOCDetectionEvaluator
   on the 2007 test split (11-point; AP, AP50, AP75 finite), the ground
   truth through ``process`` at AP50 100, B1 and B2 once a step (the box
   pool); ``faster_rcnn_R_50_C4.yaml``: the 16 x 800x1344 batch forward,
   B1 on res4 (1024 channels), held on its pool.

32. PanopticFPN R50-FPN (``panoptic_fpn_R_50_3x.yaml`` as it is): two
   DefaultPredictor requests (instances, sem_seg, panoptic_seg) and the
   16 x 800x1344 batch forward, B1 twice a forward, held on the recorded
   pools; 4 DefaultTrainer steps at 16 images on a synthetic
   ``coco_2017_train_panoptic_separated`` (``testing.
   write_synthetic_coco_panoptic``, under the run's own
   ``$DETECTRON2_DATASETS``, a temporary directory set before the port is
   imported), a checkpoint at 2, B1/B2 twice a step held on the first
   batch; ``train_net --eval-only`` of the checkpoint on
   ``coco_2017_val_100_panoptic_separated`` (16 images) through
   SemSegEvaluator, COCOEvaluator and COCOPanopticEvaluator;
   ``lazyconfig_train_net --eval-only`` of ``panoptic_fpn_R_50_1x.py`` on
   the same images, B1 held on its 14x14 box pool; the ground truth fed
   back at PQ, mIoU and bbox AP 100;
33. SemanticSegmentor R50-FPN (``Misc/semantic_R_50_FPN_1x.yaml``): two
   requests and the batch forward, 4 DefaultTrainer steps on the
   synthetic ``coco_2017_train_panoptic_stuffonly`` and SemSegEvaluator on
   ``coco_2017_val_100_panoptic_stuffonly``, the labels fed back at mIoU
   100; B1-B4 launch 0 times.
34. The R-CNN options, yamls as they are: Fast R-CNN
   (``fast_rcnn_R_50_FPN_1x.yaml``, ``PrecomputedProposals``) with its
   ``DATASETS.PROPOSAL_FILES_*`` set to a synthetic d2 proposal file
   (``testing.write_synthetic_proposals``) over 32 synthetic COCO images of
   480x800: the test loader's 16 x 800x1344 batch with 1000 proposals an
   image, B1 once a forward, held on its box pool; 4 DefaultTrainer steps
   at 16 images and 2000 proposals an image, B1/B2 once a step, held on the
   first batch, then COCOEvaluator bbox over 16 images; no RPN. The GIoU
   yaml (the RPN's GIoU at weight 2, the box head's at 10): 4 steps, the
   first step's two GIoU calls held against the loss in float64, B1/B2
   held on the first batch. The pred-boxes quick schedule: its losses with
   ``TRAIN_ON_PRED_BOXES`` equal those without on one fixed batch, 3 steps;
35. Cityscapes (``Cityscapes/mask_rcnn_R_50_FPN.yaml``) on a synthetic
   tree of 8 train and 2 val images of 1024x2048
   (``testing.write_synthetic_cityscapes``, under the builtin names): 4
   DefaultTrainer steps at 8 images, 800-1024 / 2048, a checkpoint at 2,
   B1/B2 twice a step, held and timed on the first batch (p2 up to
   256x512), their times on a line with the card's name and power limit;
   ``train_net --eval-only`` of the step-2 checkpoint through
   CityscapesInstanceEvaluator (segm AP, AP50); CityscapesSemSegEvaluator
   on constant predictions and on the labels fed back (IoU 100);
36. MViTv2, lazy configs as they are (bf16, seeded weights, score
   threshold 0): ``ViTDet/cascade_mask_rcnn_mvitv2_b_in21k_100ep.py``, 2
   DefaultPredictor requests and a batch forward of 8 x 1024x1024 (B1 four
   times a forward: three cascade box pools and the mask pool, held on the
   recorded pools), then 3 ``lazyconfig_train_net`` steps at 8 images (for
   its 64) and the evaluation over 2 images: B1/B2 four times a step, held
   on the first batch; ``MViTv2/mask_rcnn_mvitv2_t_3x.py``, one recorded
   and 2 timed batch forwards of 16 x 800x1344 (its 200x336 first stage
   pads the 56x56 windows); B3/B4 0 times (the attention is plain);
37. Swin, ``ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py`` as phase 36's
   cascade (the 256x256 first stage pads its 7x7 windows to 259);
38. RegNet: ``COCO-InstanceSegmentation/mask_rcnn_regnetx_4gf_dds_fpn_1x.py``
   (FrozenBN calibrated on two noise images, the config's own
   ``GeneralizedRCNN.from_config(cfg).clone(backbone=...)``), 2 requests, a
   batch forward of 16 x 800x1344, 3 steps at its 16 images;
   ``new_baselines/mask_rcnn_regnety_4gf_dds_FPN_100ep_LSJ.py`` (SE,
   SyncBN under batch statistics), 3 steps at 8 images of 1024x1024; B1/B2
   twice a step, held on the first batches.
39. deformable convolution, ``Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml``
   (bf16, seeded weights, every ``conv2_offset`` drawn so that its offsets
   have a 2 px std: fractional, some samples off the map, checked): 2
   requests and a batch forward of 16 x 800x1344, B1 twice a forward, held
   on the recorded pools; the op on res3.0's recorded input in float32 on
   the card against float64 on the host (1e-4 of the largest value) and
   timed beside a plain 3x3 conv; 4 DefaultTrainer steps at the yaml's 16
   images (the op recomputed in the backward), B1/B2 twice a step, held on
   the first batch, the offset and deformable convs moved, the peak
   memory; one batch forward of ``Misc/panoptic_fpn_R_101_dconv_cascade_gn_
   3x.yaml`` (R101 GN, cascade), B1 four times, held on its pools;
40. chart DensePose R-CNN through ``densepose_train_net``'s setup and
   Trainer on a synthetic DensePose-COCO (``testing.
   write_synthetic_densepose_coco``, the builtin ``densepose_coco_2014_*``
   names under the run's ``$DETECTRON2_DATASETS``):
   ``DensePose/densepose_rcnn_R_50_FPN_s1x.yaml`` (the FPN decoder), 2
   requests and a batch forward of 16 x 800x1344 (``pred_densepose`` with
   the parts in 0..24 and U/V in [0, 1], zeros past 24 slots), B1 once a
   forward (the box pool), the decoder pool (``roi_align_separable_chan``)
   held to ``roi_align_multilevel_plain`` on the one level in float32 (1e-5)
   and timed, 4 steps at 16 images; the ``_legacy`` yaml (its 14x14
   DensePose pool over p2-p5 is B1's, B2's in training) and ``DL_WC1``
   (DeepLab head, iid UV confidence): a batch forward and 2 steps each;
   finite ``loss_densepose_*``, the DensePose heads moved; B1/B2 held to
   their plain versions at every pool; B3/B4 0 times. Each training ends
   with the DensePose evaluator on the synthetic SMPL tables
   (``testing.write_synthetic_densepose_eval_data``): finite GPS, GPSM and
   segm sections, the evaluator's seconds logged; so does
   ``densepose_train_net --eval-only`` of the decoder config on its 2
   minival images. The minival ground truth fed back through the
   evaluator's ``process`` and its reading of the dataset
   (``testing.densepose_ground_truth_outputs``): segm AP 100, GPS AP at
   least 80.
41. Human CSE DensePose R-CNN at full width (``cse/densepose_rcnn_R_50_FPN_
   s1x.yaml``: the SMPL embedder, 27554 vertices x 256 synthetic LBO
   features projected to 16, ``EmbeddingLoss``): 2 requests and a batch of
   16 x 800x1344 (finite embeddings, boolean foreground, nearest vertices
   in range), then 4 steps of the DensePose Trainer at 16 images on the
   synthetic ``densepose_coco_2014_*_cse`` with flips through the SMPL
   symmetry table; finite losses, the projection moved.
42. Animal CSE DensePose R-CNN at full width on a synthetic DensePose-LVIS:
   the 4k yaml (9 meshes, ``SoftEmbeddingLoss``,
   ``COARSE_SEGM_TRAINED_BY_MASKS``, 9 classes from the category
   whitelist): a batch of 16, 3 steps at 16; then 2 steps each of the i2m
   (pixel-to-shape) and m2m (shape-to-shape, with SMPL's 3 GB geodesics
   computed on the card for the phase) yamls, each cycle loss finite and
   non-zero. B1/B2 once a step in 41-42, held to their plain versions on
   each config's first batch; B3/B4 0 times.
43. HRNet + HRFPN DensePose R-CNN: the HRFPN backbone on the card in
   float32 against ``tests/goldens/hrfpn_backbone.npz`` (5e-3);
   ``densepose_rcnn_HRFPN_HRNet_w32_s1x.yaml`` (bf16, seeded weights, every
   BN calibrated on two noise images): 2 requests and a batch forward of 16
   x 800x1344, B1 once a forward over the box pool's five levels (p1-p5,
   strides 4-64), held on the recorded pool; 3 steps of the DensePose
   Trainer at its 16 images (BN on batch statistics), B1/B2 once a step,
   held on the first batch, step and data_time logged; one batch forward of
   the ``_w48`` yaml.
44. DensePose bootstrap training, ``evolution/densepose_R_50_FPN_DL_WC1M_3x_
   Atop10P_CA_B_uniform.yaml`` through ``densepose_train_net``'s Trainer
   (bf16, both weights seeded): ``base_coco_2017_train`` (a synthetic COCO
   2017, raw ids whitelisted and mapped onto person) and
   ``densepose_coco_2014_train`` mixed 1:1 with the pseudo-labels the
   bootstrap model draws on an image list of synthetic PNGs (for
   ChimpnSee's videos; the filter at 0.0 for 0.8, 4 detections an image):
   3 steps at 16 images, pseudo-labelled instances at every step, their
   points inside their boxes, parts in 1..24, U/V in [0, 1]; B1 once a
   bootstrap forward and once a step, B2 once a step, held on a recorded
   bootstrap pool and the first train step's; the bootstrap inference per
   image, step and data_time logged.
45. PointRend and PointSup, each cfg from ``get_cfg()``,
   ``add_pointrend_config`` (and ``add_point_sup_config``), then the zoo
   yaml (bf16, seeded weights): the PointRend R18 golden on the card in
   float32 through the d2 loader; ``pointrend_rcnn_R_50_FPN_3x_coco.yaml``:
   2 requests, a batch of 16 x 800x1344 (28x28 subdivision masks in [0, 1],
   pasted on the card), 3 DefaultTrainer steps at 16 images (bitmask gt),
   COCOEvaluator over 4 images; ``implicit_pointrend_R_50_FPN_3x_coco.yaml``:
   the batch (224x224 masks) and 2 steps; the semantic R101-FPN Cityscapes
   yaml: a 1024x2048 request, a batch of 4 at 1024x2048, 2 steps of 2
   crops (the mapper crops 512x1024, then resizes to up to 2048x4096, so 2
   hold the pixels of its 32), CityscapesSemSegEvaluator, B1-B4 at 0;
   PointSup and
   Implicit PointSup: 3 and 2 SimpleTrainer steps at 8 x 800x1344 with 5
   annotated points an instance. B1 once a forward and B2 once a step on
   the PointRend paths (the box pool: the mask branch samples points), twice
   each on PointSup's (box and 14x14 mask pools), held to their plain
   versions on the recorded pools; finite losses (``loss_mask_point``,
   ``loss_l2``), the mask heads moved. In phases 34-45 B3/B4's counts are
   checked before every zeroing of the counts (``attention_free``), so each
   run's 0 is read.

``--vitdet-train-only`` runs phases 1, 2 and 23 alone, ``--bn-only`` phases
1, 2, 24 and 25, ``--dense-only`` phases 1, 2 and 26-28, ``--lvis-voc-only``
phases 1, 2 and 29-31, ``--seg-only`` phases 1, 2, 32 and 33,
``--rcnn-options-only`` phases 1, 2, 34 and 35, ``--backbones-only``
phases 1, 2 and 36-38, ``--dconv-densepose-only`` phases 1, 2, 39 and 40,
``--cse-only`` phases 1, 2 and 40-42, ``--hrfpn-bootstrap-only`` phases 1,
2, 43 and 44, ``--pointrend-only`` phases 1, 2 and 45 (no result line;
``--pointrend-only`` prints a kernels line of B1-B4 from phase 45).

Each phase logs its seconds, and the run its total.

Phase 8 also holds both entry points at ViT-H's head dim 80, [16, 4096, 80]
(global) and [400, 196, 80] (windowed), in float32 and bfloat16 with the
bias, and requires the kernels of those shapes (``simt_f32``, ``mma_tiled``).

Beside each main-path time of the RoIAlign forward and backward and the
attention kernels the run logs the time before their redesign (constants
below); the JSON line
of the kernels holds only what this run measured, and the bounds.
The line before the last is the JSON of the ported kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM data sheet
F32_TOL = 1e-5
B, H, W, C = 16, 800, 1344, 256
STRIDES = (4, 8, 16, 32)
BOX_ROIS, BOX_RES = 1000, 7  # per image
MASK_ROIS, MASK_RES = 100, 14
# training: ROI_HEADS.BATCH_SIZE_PER_IMAGE box rois and its positive
# fraction (the mask branch's foreground budget) per image
TRAIN_B, TRAIN_BOX_ROIS, TRAIN_MASK_ROIS, TRAIN_G = 8, 512, 128, 50
TRAIN_STEPS = 10
LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")
# phase 10: the synthetic COCO it evaluates on (64 images until phases 41-42
# came, PERF.md section 4), and the zoo config
EVAL_IMAGES = 32
EVAL_CONFIG = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"
EVAL_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl")  # what print_csv_format prints
# phase 11: DefaultTrainer's steps, checkpoint period and test images (12
# steps and a checkpoint at 6, not 20 and 10, since phases 36-38 came: the
# whole run stays within 70% of its time limit, PERF.md section 4)
# 12 and 6 steps until phases 39-40 came, 16 test images until 41-42, 8 until 43-44 (PERF.md section 4)
TRAINER_ITERS, TRAINER_CKPT_PERIOD, TRAINER_TEST_IMAGES = 6, 3, 4
# phases 12 and 22: the train->AP gates' floors (tests/test_train_to_ap.py:166-167, :226)
GATE_FLOORS = {"bbox": 90.0, "segm": 79.0}
KEYPOINT_GATE_FLOORS = {"keypoints": 20.0}
GATE_REPRO_ITERS = 100  # --gate-determinism: steps per run
# Kernel times before the redesign of the RoIAlign forward and the attention
# kernels, ms on the main paths' own inputs, taken with this script on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6 keeps them as the earlier
# times). Logged beside this run's times, never put into the kernels line.
PREV_MS_FROM = "H100 80GB HBM3, 700 W, before the redesign (PERF.md section 6)"
PREV_ROI_FWD_MS = {
    "inference": {7: 3.5450, 14: 1.3832},
    "train": {7: 0.9203, 14: 0.8904},
    "vitdet": {7: 1.7566, 14: 0.6972},
}
# the RoIAlign backward before its redesign as a per-tile gather (PERF.md
# section 6; "synthetic": phase 6's inputs, "train": phase 7's recorded ones)
PREV_ROI_BWD_MS = {
    "synthetic": {7: 2.0382, 14: 1.6619},
    "train": {7: 2.2919, 14: 1.9864},
}
PREV_ATTN_MS = {
    False: {"global": 2.5888, "windowed": 0.3990},
    True: {"global": 2.5581, "windowed": 0.3931},
}
# the kernel of csrc/flash_attention.cu each ViTDet-B main-path shape must take
ATTN_MAIN_PATHS = {"global": "wgmma", "windowed": "mma_window"}


def log(*args):
    print(*args, flush=True)


def check(cond, msg="") -> None:
    """A failed check fails the run (not an assert: it must hold under -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_leftovers(label: str, top: int = 8) -> float:
    """GiB the caching allocator holds for tensors, before and after a
    ``gc.collect()``; where more than 0.25 GiB stays, the largest live CUDA
    tensors Python can reach are logged with what refers to them (by type,
    and for a dict its first keys). Returns the GiB after the collection."""
    import gc

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated() / 2**30
    log(f"  {label}: {before:.2f} GiB allocated, {after:.2f} GiB after gc.collect()")
    if after > 0.25:
        storages = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.is_cuda:
                st = o.untyped_storage()
                storages.setdefault(st.data_ptr(), (st.nbytes(), o))
        reachable = sum(nbytes for nbytes, _ in storages.values()) / 2**30
        log(f"    {len(storages)} CUDA storages reachable from Python hold {reachable:.2f} GiB")
        for nbytes, o in sorted(storages.values(), key=lambda v: -v[0])[:top]:
            holders = []
            for r in gc.get_referrers(o):
                if isinstance(r, dict):
                    holders.append("dict(" + ", ".join(map(str, list(r)[:4])) + ")")
                elif not isinstance(r, list) or len(r) < 1000:  # not gc.get_objects()' own list
                    holders.append(type(r).__name__)
            log(f"    {nbytes / 2**20:9.1f} MiB {tuple(o.shape)} {o.dtype}, held by {holders[:4]}")
    return after


def event_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_rois(gen, n_per_image: int, device, batch: int = B):
    """Boxes like a detector's over 800x1344 images: log-uniform sizes 2-900 px,
    aspect 1/3-3, centres spread 10% past each edge; 2% zero-area and the last
    5% of every image's slots padded with zero rows."""
    import torch

    n = batch * n_per_image
    u = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    size = torch.exp(u(n) * (np.log(900.0) - np.log(2.0)) + np.log(2.0))
    aspect = torch.exp((u(n) * 2 - 1) * np.log(3.0))
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    cx = u(n) * W * 1.2 - 0.1 * W
    cy = u(n) * H * 1.2 - 0.1 * H
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    zero_area = u(n) < 0.02
    boxes[zero_area, 2] = boxes[zero_area, 0]
    boxes = boxes.reshape(batch, n_per_image, 4)
    boxes[:, int(n_per_image * 0.95) :] = 0
    bidx = torch.arange(batch, device=device, dtype=torch.int32).repeat_interleave(n_per_image)
    return boxes.reshape(-1, 4).contiguous(), bidx


def roi_taps(shapes, boxes, bidx, levels, scales, res, sr, aligned):
    """(feature rows some inside sample taps, inside samples) on these inputs."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_sample_taps

    t = roi_align_sample_taps(shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    inside = t["yin"][:, :, None] & t["xin"][:, None, :]
    rows = []
    for y in (t["ylo"], t["yhi"]):
        for x in (t["xlo"], t["xhi"]):
            idx = t["base"][:, None, None] + y[:, :, None] * t["W"][:, None, None] + x[:, None, :]
            rows.append(idx[inside])
    return torch.unique(torch.cat(rows)).numel(), int(inside.sum().item())


def roi_align_cost(feats, boxes, bidx, levels, scales, res, sr, aligned):
    """(bytes, flops) the forward needs on these inputs: each feature row that
    some inside sample taps, read once; boxes and indices read once; the
    output written once; 2 flops per tap and channel for inside samples."""
    shapes = [tuple(f.shape) for f in feats]
    touched, inside = roi_taps(shapes, boxes, bidx, levels, scales, res, sr, aligned)
    item = feats[0].element_size()
    R, C = boxes.shape[0], shapes[0][-1]
    nbytes = touched * C * item + R * (16 + 4 + 4) + R * res * res * C * item
    return nbytes, 2 * 4 * inside * C


# The backward's geometry in csrc/roi_align.cu, for the traffic model below:
# pixels of a list tile (D2T_TILE) and of the block of pixel rows x columns
# that shares one read of each cotangent word (D2T_BWD_WARPS x D2T_BWD_COLS).
ROI_BWD_TILE = 16
ROI_BWD_BLOCK = (8, 4)


def roi_align_backward_cost(g, shapes, boxes, bidx, levels, scales, res, sr, aligned):
    """(bytes, flops, design_bytes) of the backward on these inputs. The
    bound's bytes are what the function must move: the cotangent, boxes and
    indices read once and the dense gradient over every level written once
    in the cotangent's dtype; 2 flops per tap and channel for inside
    samples. ``design_bytes`` is the least traffic the kernel's own design
    adds on top, which the bound does not count: every ``ROI_BWD_BLOCK`` of
    pixels reads the cotangent words of each bin whose inside samples tap it
    (counted here beyond the one read of the bound), and the int32 scratch
    (axis tables, rectangles, planes, the counts and offsets of the
    ``ROI_BWD_TILE`` tiles, the lists) is written once and read once. A
    model, not a measurement: it is logged, never put into the kernels line."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_sample_taps

    t = roi_align_sample_taps(shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    inside = int((t["yin"][:, :, None] & t["xin"][:, None, :]).sum().item())
    item = g.element_size()
    R, C = boxes.shape[0], shapes[0][-1]
    total = sum(s[0] * s[1] * s[2] for s in shapes) * C
    nbytes = g.numel() * item + R * (16 + 4 + 4) + total * item
    s_ = sr if sr > 0 else 2
    tile, block = ROI_BWD_TILE, ROI_BWD_BLOCK

    def spans(lo, hi, ins, size, groups):
        """[R, groups]: how many ``size``-pixel bands the inside taps of each
        group of samples (bins, or the whole roi) span."""
        big = torch.iinfo(torch.int64).max
        first = torch.where(ins, lo, big).reshape(R, groups, -1).min(-1).values
        last = torch.where(ins, hi, -1).reshape(R, groups, -1).max(-1).values
        return torch.where(last >= 0, last // size - first.clamp_max(big - 1) // size + 1, 0)

    y = (t["ylo"], t["yhi"], t["yin"])
    x = (t["xlo"], t["xhi"], t["xin"])
    reread = int((spans(*y, block[0], res).sum(1) * spans(*x, block[1], res).sum(1)).sum().item()) * C * item
    pairs = int((spans(*y, tile, 1) * spans(*x, tile, 1)).sum().item())  # list entries
    n_tiles = sum(s[0] * -(-s[1] // tile) * -(-s[2] // tile) for s in shapes)
    scratch = R * 2 * res * s_ * 16 + R * (16 + 4) + (2 * n_tiles + 1) * 4 + pairs * 4
    design = max(reread - g.numel() * item, 0) + 2 * scratch
    return nbytes, 2 * 4 * inside * C, design


def bound(nbytes, flops, peak_flops=H100_F32_FLOPS):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, label, timing=False, prev_ms=None,
                   vector=False):
    """Kernel vs plain on identical inputs; ``prev_ms``, the kernel's time
    on these inputs before its redesign, marks a main-path pool, which must
    take the 16-byte path, as must a pool given ``vector``. float32: |diff| <= 1e-5. bfloat16:
    the plain version interpolates in bf16 like the XLA path while the
    kernel accumulates in f32, so (a) against plain-bf16 the bound is
    8 roundings of 2^-9 relative to the largest tap, max|f| / 64, and
    (b) against the plain version run in f32 on the same bf16 inputs the
    only difference is the kernel's one output rounding, at most half a
    bf16 ulp, 2^-8 * |ref| per element, plus 1e-5 for the f32 sum order."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda, roi_align_multilevel_plain

    args = (feats, boxes, bidx, levels, scales, (res, res), sr, aligned)
    out = roi_align_multilevel_cuda(*args)
    path = roi_align_multilevel_cuda.last_path
    torch.cuda.synchronize()
    bf16 = feats[0].dtype != torch.float32
    feats32 = [f.float() for f in feats] if bf16 else feats
    tol = max(f.abs().max().item() for f in feats) / 64 if bf16 else F32_TOL
    # the plain versions run on slices of the rois (a C4 box pool's output
    # alone is 6.4 GB in bf16), each against the kernel's one launch
    R, C = boxes.shape[0], feats[0].shape[-1]
    step = max(1, 2**28 // (res * res * C))
    err = err32 = 0.0
    excess = float("-inf")
    for start in range(0, R, step):
        sl = slice(start, min(start + step, R))
        sub = (boxes[sl], bidx[sl], levels[sl], scales, (res, res), sr, aligned)
        o = out[sl]
        ref = roi_align_multilevel_plain(feats, *sub)
        check(o.shape == ref.shape and o.dtype == ref.dtype, (o.shape, ref.shape))
        check(torch.isfinite(o.float()).all(), label)
        err = max(err, (o.float() - ref.float()).abs().max().item())
        if bf16:
            ref32 = roi_align_multilevel_plain(feats32, *sub)
            diff32 = (o.float() - ref32).abs()
            err32 = max(err32, diff32.max().item())
            excess = max(excess, (diff32 - (2.0**-8 * ref32.abs() + 1e-5)).max().item())
        del ref
    if not bf16:
        line = f"{label}: max_abs_err {err:.3e} (tol {tol:.1e})"
    else:
        line = (
            f"{label}: max_abs_err vs bf16 plain {err:.3e} (tol {tol:.3e}), "
            f"vs f32 plain {err32:.3e} (tol 2^-8*|ref|+1e-5 per element)"
        )
        check(excess <= 0, line)
    check(err <= tol, line)
    log("  " + line)
    del out, feats32
    res_d = {"max_abs_err": err, "path": path}
    if prev_ms is not None or vector:
        check(res_d["path"] == "vector", f"{label}: took the {res_d['path']} path")
    if timing:
        res_d["ms"] = event_ms(lambda: roi_align_multilevel_cuda(*args), 3, 20)
        res_d["plain_ms"] = event_ms(lambda: roi_align_multilevel_plain(*args), 1, 3)
        nbytes, flops = roi_align_cost(feats, boxes, bidx, levels, scales, res, sr, aligned)
        res_d["bound_ms"], res_d["bound_by"] = bound(nbytes, flops)
        res_d["bytes"], res_d["flops"] = nbytes, flops
        log(
            f"    kernel {res_d['ms']:.4f} ms, plain {res_d['plain_ms']:.3f} ms, "
            f"bound {res_d['bound_ms']:.4f} ms by {res_d['bound_by']} "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP)"
            + (f"; {prev_ms:.4f} ms on {PREV_MS_FROM}: {prev_ms / res_d['ms']:.2f}x"
               if prev_ms is not None else "")
        )
    return res_d


def phase_kernel_vs_plain(device):
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    scales = tuple(1.0 / s for s in STRIDES)
    feats32 = [
        torch.randn(B, H // s, W // s, C, generator=gen, device=device) for s in STRIDES
    ]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    results = {}
    for res, n in ((BOX_RES, BOX_ROIS), (MASK_RES, MASK_ROIS)):
        boxes, bidx = synthetic_rois(gen, n, device)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        log(f"  shape: {boxes.shape[0]} rois at {res}x{res}, levels {[tuple(f.shape) for f in feats16]}, "
            f"rois per level {torch.bincount(levels, minlength=4).tolist()}")
        for dtype, feats in (("f32", feats32), ("bf16", feats16)):
            for aligned in (True, False):
                for sr in (0, 2):
                    timing = dtype == "bf16" and aligned and sr == 0
                    r = compare_kernel(
                        feats, boxes, bidx, levels, scales, res, sr, aligned,
                        f"R={boxes.shape[0]} {res}x{res} {dtype} aligned={aligned} sr={sr}", timing,
                    )
                    if timing:
                        results[res] = r
    return results


def phase_golden(device):
    import torch

    from detectron2_tpu_torch.checkpoint import load_state_dict_report
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.testing import compare_with_golden, golden_r18_config, golden_state_dict

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "e2e_maskrcnn_r18.npz"))
    model = build_model(golden_r18_config(), device=device)
    log("  " + load_state_dict_report(model, golden_state_dict(golden)).splitlines()[0])
    out = model({"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)})
    torch.cuda.synchronize()
    errs = compare_with_golden(out, golden)
    log(f"  R18-FPN fixture on the card, f32: reproduces the reference detections: {errs}")


def check_instances(inst, n, h, w) -> None:
    """One request's result: n boxes inside the h x w image, n full-size masks."""
    import torch

    boxes, masks = inst.pred_boxes.tensor, inst.pred_masks.tensor
    check(len(inst.pred_boxes) == n and masks.shape == (n, h, w) and masks.dtype == torch.bool)
    check(torch.isfinite(boxes).all() and (boxes[:, 0::2] <= w).all() and (boxes[:, 1::2] <= h).all())
    check((boxes >= 0).all() and torch.isfinite(inst.scores).all())


def phase_main_path(device):
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.model_zoo import mask_rcnn_R_50_FPN_3x_config
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    cfg = mask_rcnn_R_50_FPN_3x_config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.PASTE_MASKS_IN_GRAPH = True
    predictor = DefaultPredictor(cfg, device=device)
    model = predictor.model
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    images = torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[H, W]] * B, dtype=torch.int32, device=device)}
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  R50-FPN Mask R-CNN, {n_params} parameters, bf16 compute, in-graph paste")

    # (a) DefaultPredictor, 3 requests of different sizes
    rng = np.random.RandomState(0)
    roi_align_multilevel_cuda.launches = 0
    for h, w in ((480, 640), (600, 800), (427, 1000)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = len(inst)
        check(n > 0, "no detections")
        check_instances(inst, n, h, w)
        log(f"  request {h}x{w}: {n} instances, masks {tuple(inst.pred_masks.tensor.shape)}, {dt * 1e3:.1f} ms")
    predictor_launches = roi_align_multilevel_cuda.launches
    check(predictor_launches == 2 * 3, predictor_launches)

    # (b) batch forward, 16 x 800x1344; the first forward also records the
    # pooler inputs for the comparison below
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    iters = 3
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 2)
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = model(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    batch_launches = roi_align_multilevel_cuda.launches
    check(batch_launches == 2 * (1 + iters), batch_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  batch forward 16x800x1344: {dt * 1e3:.1f} ms/batch, {B / dt:.2f} img/s, peak memory {peak:.2f} GiB")
    log(f"  RoIAlign kernel launches: {predictor_launches} over 3 requests, {batch_launches} over {1 + iters} batch forwards")

    if "--profile" in sys.argv[1:]:
        profile_run(lambda: model(batch), "forward", "main_path_trace.json")

    D = cfg.TEST.DETECTIONS_PER_IMAGE
    check(out["pred_boxes"].shape == (B, D, 4) and out["pred_masks"].shape == (B, D, 28, 28))
    check(out["pred_masks_full"].shape == (B, D, H, W) and out["pred_masks_full"].dtype == torch.bool)
    check(torch.isfinite(out["pred_boxes"]).all() and torch.isfinite(out["pred_masks"]).all())
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    log(f"  detections per image: {n_valid}")

    # the kernel against the plain version on the main path's own inputs
    check(len(recorded) == 2, len(recorded))
    shapes = {}
    for (args, kwargs), res in zip(recorded, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        r = compare_kernel(
            feats, boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"],
            f"main-path pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["inference"][res],
        )
        shapes[res] = r
    return {
        "img_s": B / dt,
        "batch_ms": dt * 1e3,
        "peak_gib": peak,
        "launches": predictor_launches + batch_launches,
        "shapes": shapes,
        # phase 10's weights, on the host: the model is freed with this phase
        "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
    }


# the RoIAlign backward's five kernels, summed in a profile
ROI_BWD_KERNELS = ("d2t_bwd_", "d2t_roi_align_bwd")


def profile_run(fn, label: str, trace_name: str, top: int = 25):
    """``--profile``: device time by kernel over one call of ``fn``
    (torch.profiler), the device's busy share of the wall time, and a Chrome
    trace in chiprun_out/ (none when ``trace_name`` is None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels and copies on the card
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, count + 1)
    rows = [(ms, count, name) for name, (ms, count) in by_name.items()]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernels")
    for ms, count, key in rows[:top]:
        log(f"    {ms:9.3f} ms  {count:6d}x  {key[:110]}")
    bwd = [r for r in rows if any(k in r[2] for k in ROI_BWD_KERNELS)]
    if bwd:
        log(f"    RoIAlign backward (prep, count, scan, fill, accumulate): {sum(r[0] for r in bwd):.3f} ms "
            f"in {sum(r[1] for r in bwd)} launches of {len(bwd)} kernels")
    if trace_name is None:
        return
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, trace_name))


def compare_backward(g, shapes, boxes, bidx, levels, scales, res, sr, aligned, label, timing=False, prev_ms=None):
    """Backward kernel vs plain backward on identical inputs. Per element
    |kernel - plain(float32)| <= 1e-5 * A + 1e-7, A the plain backward of
    |g|: the kernel adds the same terms in another order (each bin's sample
    weights summed first, rois in tile-list order), and A bounds that sum's
    rounding; for a bfloat16 cotangent plus half a bf16 ulp of the float32
    result, 2^-8 * |ref|, the kernel's one rounding. The check fails too if
    the tolerance covers |ref| everywhere, where a kernel that wrote zeros
    would pass: scale a tiny ``g`` up first. A second launch must give the
    same bits. ``prev_ms``, the time on these inputs before the redesign,
    marks a main-path pool, which must take the 16-byte path."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import (
        roi_align_multilevel_backward_cuda,
        roi_align_multilevel_backward_plain,
    )

    args = (shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    out = roi_align_multilevel_backward_cuda(g, *args)
    path = roi_align_multilevel_backward_cuda.last_path
    again = roi_align_multilevel_backward_cuda(g, *args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)), f"{label}: two launches differ")
    del again
    ref = roi_align_multilevel_backward_plain(g.float(), *args)
    bound_a = roi_align_multilevel_backward_plain(g.float().abs(), *args)
    err, excess, margin, ref_max = 0.0, float("-inf"), float("-inf"), 0.0
    for o, r, a in zip(out, ref, bound_a):
        check(o.shape == r.shape and o.dtype == g.dtype, (o.shape, o.dtype, r.shape))
        check(torch.isfinite(o.float()).all(), label)
        diff = (o.float() - r).abs()
        tol = 1e-5 * a + 1e-7
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0**-8 * r.abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - tol).max().item())
        margin = max(margin, (r.abs() - tol).max().item())
        ref_max = max(ref_max, r.abs().max().item())
    del out, ref, bound_a
    line = (
        f"{label} [{path}]: max_abs_err vs f32 plain {err:.3e}, max|ref| {ref_max:.3e} "
        f"(tol 1e-5*A+1e-7{' + 2^-8*|ref|' if g.dtype == torch.bfloat16 else ''} per element); "
        f"two launches bitwise equal"
    )
    check(excess <= 0, line)
    check(margin > 0, f"{line}: the tolerance covers |ref| everywhere, a zero gradient would pass")
    log("  " + line)
    res_d = {"max_abs_err": err, "path": path}
    if prev_ms is not None:
        check(path == "vector", f"{label}: took the {path} path")
    if timing:
        res_d["ms"] = event_ms(lambda: roi_align_multilevel_backward_cuda(g, *args), 3, 10)
        res_d["plain_ms"] = event_ms(lambda: roi_align_multilevel_backward_plain(g, *args), 1, 2)
        nbytes, flops, design = roi_align_backward_cost(g, *args[:5], res, sr, aligned)
        res_d["bound_ms"], res_d["bound_by"] = bound(nbytes, flops)
        res_d["bytes"], res_d["flops"] = nbytes, flops
        log(
            f"    kernel {res_d['ms']:.4f} ms, plain {res_d['plain_ms']:.3f} ms, "
            f"bound {res_d['bound_ms']:.4f} ms by {res_d['bound_by']} "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP); the design adds >= {design / 1e9:.4f} GB"
            + (f"; {prev_ms:.4f} ms on {PREV_MS_FROM}: {prev_ms / res_d['ms']:.2f}x" if prev_ms is not None else "")
        )
        if "--profile" in sys.argv[1:]:
            profile_run(lambda: roi_align_multilevel_backward_cuda(g, *args), f"{label}, one call", None, top=8)
    return res_d


def phase_backward_vs_plain(device):
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    scales = tuple(1.0 / s for s in STRIDES)
    shapes = [(TRAIN_B, H // s, W // s, C) for s in STRIDES]
    results = {}
    for res, n in ((BOX_RES, TRAIN_BOX_ROIS), (MASK_RES, TRAIN_MASK_ROIS)):
        boxes, bidx = synthetic_rois(gen, n, device, TRAIN_B)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        log(f"  shape: {boxes.shape[0]} rois at {res}x{res}, levels {shapes}, "
            f"rois per level {torch.bincount(levels, minlength=4).tolist()}")
        g32 = torch.randn((boxes.shape[0], res, res, C), generator=gen, device=device)
        for dtype, g in (("f32", g32), ("bf16", g32.bfloat16())):
            for aligned in (True, False):
                for sr in (0, 2):
                    timing = dtype == "bf16" and aligned and sr == 0
                    r = compare_backward(
                        g, shapes, boxes, bidx, levels, scales, res, sr, aligned,
                        f"bwd R={boxes.shape[0]} {res}x{res} {dtype} aligned={aligned} sr={sr}", timing,
                        prev_ms=PREV_ROI_BWD_MS["synthetic"][res] if timing else None,
                    )
                    check(r["path"] == "vector", f"C={C}: the backward took the {r['path']} path")
                    if timing:
                        results[res] = r
    return results


def synthetic_train_batch(device):
    """A padded batch as tools/_bench_train.py builds it: 8 x 800x1344
    uint8 images, 50 gt slots per image of which 5-50 are valid, boxes
    16-316 px with corners from 0-600 px (scaled by H/800 at other sizes),
    80 classes, 28x28 gt masks."""
    import torch

    rng = np.random.RandomState(0)
    Bt, G = TRAIN_B, TRAIN_G
    xy = rng.rand(Bt, G, 2) * 600 * (H / 800)
    wh = (rng.rand(Bt, G, 2) * 300 + 16) * (H / 800)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(G)[None, :] < rng.randint(5, G + 1, (Bt, 1))
    boxes[~valid] = 0
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "image": as_t(rng.randint(0, 256, (Bt, H, W, 3)).astype(np.uint8)),
        "image_sizes": as_t(np.tile(np.array([[H, W]], np.int32), (Bt, 1))),
        "gt_boxes": as_t(boxes),
        "gt_classes": as_t(rng.randint(0, 80, (Bt, G)).astype(np.int32)),
        "gt_valid": as_t(valid),
        "gt_masks": as_t((rng.rand(Bt, G, 28, 28) > 0.5).astype(np.float32)),
    }


def phase_train(device, workdir):
    import itertools

    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.checkpoint import DetectionCheckpointer
    from detectron2_tpu_torch.engine import SimpleTrainer, hooks
    from detectron2_tpu_torch.model_zoo import mask_rcnn_R_50_FPN_3x_config
    from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer

    cfg = mask_rcnn_R_50_FPN_3x_config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    # the 3x schedule warms up over 1000 iterations: its first steps' LR
    # (2e-5 and up) moves the mask head's weights by less than a float32 ulp,
    # so the smoke run ramps to BASE_LR over its own steps instead
    cfg.SOLVER.WARMUP_ITERS = 10 * TRAIN_STEPS
    torch.manual_seed(0)  # the samplers' draws
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    batch = synthetic_train_batch(device)
    calibrate_frozen_bn(model, {k: batch[k][:2] for k in ("image", "image_sizes")})
    optimizer = build_optimizer(cfg, model)
    scheduler = build_lr_scheduler(cfg, optimizer)
    params0 = {name: p.detach().clone() for name, p in model.named_parameters()}
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"  R50-FPN Mask R-CNN, {sum(v.numel() for v in params0.values())} parameters ({n_train} trainable), "
        f"bf16 compute, batch {TRAIN_B} x {H}x{W}, gt per image {batch['gt_valid'].sum(1).tolist()}")

    # the first step records the pooler inputs and the cotangents reaching them
    recorded = []
    kernel_entry = poolers.roi_align_multilevel

    trainer = SimpleTrainer(model, itertools.repeat(batch), optimizer)
    trainer.register_hooks([hooks.IterationTimer(warmup_iter=2), hooks.LRScheduler(optimizer, scheduler)])
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_backward_cuda.launches = 0
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    try:
        trainer.train(0, TRAIN_STEPS)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    fwd_launches = roi_align_multilevel_cuda.launches
    bwd_launches = roi_align_multilevel_backward_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(fwd_launches == 2 * TRAIN_STEPS, f"forward kernel launches {fwd_launches}")
    check(bwd_launches == 2 * TRAIN_STEPS, f"backward kernel launches {bwd_launches}")

    storage = trainer.storage
    for k in LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == TRAIN_STEPS and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))
    step_times = [v for v, _ in storage.history("time").values()]
    step_ms = storage.history("time").median(TRAIN_STEPS) * 1e3
    mean_ms = sum(step_times) / len(step_times) * 1e3
    lrs = [v for v, _ in storage.history("lr").values()]
    log(f"  lr {lrs[0]:.3e} -> {lrs[-1]:.3e}; train step over steps 3-{TRAIN_STEPS}: median {step_ms:.1f} ms, "
        f"mean {mean_ms:.1f} ms ({TRAIN_B / step_ms * 1e3:.2f} and {TRAIN_B / mean_ms * 1e3:.2f} img/s), "
        f"peak memory {peak:.2f} GiB")
    log("  step times (ms): " + ", ".join(f"{v * 1e3:.1f}" for v in step_times))
    log(f"  RoIAlign launches over {TRAIN_STEPS} steps: forward {fwd_launches}, backward {bwd_launches}")

    unchanged, moved_frozen = [], []
    frozen_prefixes = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), params0[name])
        if name.startswith(frozen_prefixes):
            check(not p.requires_grad, f"{name} should be frozen")
            if not same:
                moved_frozen.append(name)
        elif not p.requires_grad:
            raise RuntimeError(f"check failed: {name} is frozen but outside stem/res2")
        elif same:
            unchanged.append(name)
    check(not unchanged, f"trainable parameters that did not move: {unchanged}")
    check(not moved_frozen, f"frozen parameters that moved: {moved_frozen}")
    log(f"  every trainable parameter moved; the frozen stem and res2 did not")

    # both kernels against their plain versions on the first step's inputs
    check(len(recorded) == 2 and all("grad" in r for r in recorded), len(recorded))
    fwd, bwd = {}, {}
    with torch.no_grad():
        for rec, res in zip(recorded, (BOX_RES, MASK_RES)):
            feats, boxes, bidx, levels, scales, size = rec["args"]
            feats = [f.detach() for f in feats]
            sr, aligned = rec["kwargs"]["sampling_ratio"], rec["kwargs"]["aligned"]
            fwd[res] = compare_kernel(
                feats, boxes, bidx, levels, scales, res, sr, aligned,
                f"train-step pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["train"][res],
            )
            # the loss-normalized cotangents are tiny (max ~1e-8), under the
            # tolerance's 1e-7 floor; the backward is linear in them, so scale
            # them by a power of two, exactly, to a max in [1, 2)
            g = rec["grad"]
            g_max = g.float().abs().max().item()
            check(g_max > 0, f"pool {res}x{res}: the train step's cotangent is zero")
            g = g * 2.0 ** -math.floor(math.log2(g_max))
            shapes = [tuple(f.shape) for f in feats]
            scaled = f"cotangent x 2^{-math.floor(math.log2(g_max))}"
            bwd[res] = compare_backward(
                g, shapes, boxes, bidx, levels, scales, res, sr, aligned,
                f"train-step bwd R={boxes.shape[0]} {res}x{res} bf16 ({scaled})",
                timing=True, prev_ms=PREV_ROI_BWD_MS["train"][res],
            )
            # the same rois and cotangent in both dtypes, on both grids, at
            # both sampling ratios
            for dtype in (torch.float32, torch.bfloat16):
                for other_aligned in (True, False):
                    for other_sr in (0, 2):
                        if (dtype, other_aligned, other_sr) == (g.dtype, aligned, sr):
                            continue
                        compare_backward(
                            g.to(dtype), shapes, boxes, bidx, levels, scales, res, other_sr, other_aligned,
                            f"train-step bwd R={boxes.shape[0]} {res}x{res} {'f32' if dtype == torch.float32 else 'bf16'} aligned={other_aligned} "
                            f"sr={other_sr} ({scaled})",
                        )
    recorded.clear()

    # the trained weights, with their calibrated FrozenBN statistics, for
    # phase 11's MODEL.WEIGHTS
    t0 = time.perf_counter()
    checkpointer = DetectionCheckpointer(model, workdir)
    checkpointer.save("phase7_r50_fpn")
    weights = checkpointer.get_checkpoint_file()
    log(f"  saved {weights} ({os.path.getsize(weights) / 2**20:.1f} MiB) in {time.perf_counter() - t0:.2f} s")

    if "--profile" in sys.argv[1:]:
        def one_step():
            losses = model(batch, train=True)
            optimizer.zero_grad(set_to_none=True)
            sum(losses.values()).backward()
            optimizer.step()

        profile_run(one_step, "train step", "train_step_trace.json")

    return {
        "train_ms_per_step": step_ms,
        "train_mean_ms_per_step": mean_ms,
        "train_img_s": TRAIN_B / step_ms * 1e3,
        "train_mean_img_s": TRAIN_B / mean_ms * 1e3,
        "train_peak_gib": peak,
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
        "weights": weights,
    }

# ViTDet-B at 8 x 1024x1024: (batch-heads, tokens, head dim, Hk, Wk)
VIT_B, VIT_HW = 8, 1024
ATTN_SHAPES = {"global": (96, 4096, 64, 64, 64), "windowed": (2400, 196, 64, 14, 14)}
ATTN_PER_FORWARD = {"global": 4, "windowed": 8}
# the plain version stores [chunk, S, S] float32 scores
ATTN_CHUNK = {"global": 24, "windowed": 600}
# ViT-H's head dim, 1280 / 16 heads = 80 (no other main path has it): one
# 1024x1024 image's global block (16 heads x 64x64 tokens) and windowed block
# (16 heads x 25 windows of 14x14), and the kernel each must take
ATTN_D80_SHAPES = {"vith_global": (16, 4096, 80, 64, 64), "vith_windowed": (400, 196, 80, 14, 14)}
ATTN_D80_CHUNK = {"vith_global": 8, "vith_windowed": 400}
ATTN_D80_PATHS = {"float32": "simt_f32", "bfloat16": "mma_tiled"}


def attention_entry(transposed: bool):
    from detectron2_tpu_torch.ops import attention as A

    return (A.flash_attention_t_cuda, A.attention_plain_t) if transposed else (A.flash_attention_cuda, A.attention_plain)


def plain_in_chunks(plain, args, scale, chunk):
    """The plain version over slices of the batch-heads (each slice is the
    whole function for its batch-heads: the arithmetic is unchanged)."""
    import torch

    B = args[0].shape[0]
    return torch.cat(
        [plain(*(None if a is None else a[s : s + chunk] for a in args), scale) for s in range(0, B, chunk)]
    )


def compare_attention(args, scale, transposed, chunk, label, timing=False, entry=None):
    """Attention kernel vs plain on identical inputs. float32: 2e-5 * max|v|
    (sum order and the exponential; the JAX package's own test holds its TPU
    kernel to 2e-5; an output is a convex combination of v's rows). bfloat16:
    per element, the bounds of ``testing.attention_bf16_bounds``, which scale
    with A = softmax @ |v| and |ref|: 2^-9 A + 2^-8 |ref| + 2e-5 max|v|
    against the plain version run in float32 on the same inputs, and that
    plus 2^-9 (1 + 2 max|bias|) A + 2^-9 |ref| against the plain version in
    bfloat16, which also rounds the summed bias. A bound that a wrong kernel
    could pass fails the check too: |ref| must exceed the float32-reference
    bound at more than half of the elements. ``entry``: another (kernel,
    plain) pair than the layout's."""
    import torch
    import torch.nn.functional as F

    from detectron2_tpu_torch.testing import attention_bf16_bounds

    kernel, plain = entry or attention_entry(transposed)
    q, k, v, rel_h, rel_w = args
    out = kernel(*args, scale=scale)
    torch.cuda.synchronize()
    path = kernel.last_path
    label = f"{label} [{path}]"
    check(out.shape == q.shape and out.dtype == q.dtype, (out.shape, out.dtype))
    check(torch.isfinite(out.float()).all(), label)
    vmax = v.float().abs().max().item()
    # q scaled in its own dtype, as the kernel and the plain version scale it
    args32 = [(q * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()] + [None if a is None else a.float() for a in args[1:]]
    ref32 = plain_in_chunks(plain, args32, 1.0, chunk)
    ref_max, ref_rms = ref32.abs().max().item(), ref32.square().mean().sqrt().item()
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    if q.dtype == torch.float32:
        tol = 2e-5 * vmax
        line = f"{label}: max_abs_err {err:.3e} (tol 2e-5*max|v| = {tol:.3e}), |ref| max {ref_max:.3f} rms {ref_rms:.3f}"
        check(err <= tol, line)
        check(ref_rms > tol, f"{line}: the tolerance covers a typical |ref|")
    else:
        args32[2] = args32[2].abs()
        weight = plain_in_chunks(plain, args32, 1.0, chunk)
        bias_max = 0.0 if rel_h is None else rel_h.float().abs().max().item() + rel_w.float().abs().max().item()
        tol32, tol16 = attention_bf16_bounds(ref32, weight, vmax, bias_max)
        del weight
        diff16 = (out.float() - plain_in_chunks(plain, args, scale, chunk).float()).abs()
        err16 = diff16.max().item()
        above = (ref32.abs() > tol32).float().mean().item()
        line = (
            f"{label}: max_abs_err vs f32 plain {err:.3e} (worst err/tol {(diff / tol32).max().item():.3f}, tol "
            f"2^-9*A+2^-8*|ref|+2e-5*max|v| per element, median {tol32.median().item():.3e}), vs bf16 plain {err16:.3e} "
            f"(worst err/tol {(diff16 / tol16).max().item():.3f}, tol median {tol16.median().item():.3e}), "
            f"|ref| max {ref_max:.3f} rms {ref_rms:.3f}, above the tolerance at {above:.1%} of the elements"
        )
        check((diff <= tol32).all(), line)
        check((diff16 <= tol16).all(), line)
        check(above > 0.5, f"{line}: the tolerance covers a typical |ref|, a wrong kernel would pass")
        del tol32, tol16, diff16
    del ref32, diff, args32
    log("  " + line)
    res = {"max_abs_err": err, "path": path}
    if timing:
        B, S, D = q.shape
        res["ms"] = event_ms(lambda: kernel(*args, scale=scale), 2, 10)
        res["plain_ms"] = event_ms(lambda: plain(*args, scale), 1, 2)
        flops = 4 * B * S * S * D
        nbytes = sum(a.numel() * a.element_size() for a in args if a is not None) + out.numel() * out.element_size()
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, H100_BF16_FLOPS)
        res["bytes"], res["flops"] = nbytes, flops
        line = (
            f"    kernel {res['ms']:.4f} ms ({flops / res['ms'] / 1e9:.1f} TFLOP/s), plain {res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.4f} ms by {res['bound_by']} against the bf16 tensor-core peak "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.1f} GFLOP)"
        )
        if rel_h is not None:
            # the yardstick: one library call on the same inputs, with the
            # [B, S, S] bias it needs materialised first (timed apart)
            def build_bias():
                h, w = (rel_h.transpose(1, 2), rel_w.transpose(1, 2)) if transposed else (rel_h, rel_w)
                return (h[:, :, :, None] + w[:, :, None, :]).contiguous().view(1, B, S, S)

            res["library_bias_ms"] = event_ms(build_bias, 1, 3)
            bias = build_bias()
            sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=bias, scale=scale)  # noqa: E731
            lib = sdpa()[0]
            res["library_max_abs_err"] = (lib.float() - out.float()).abs().max().item()
            check(res["library_max_abs_err"] <= 2.0**-5 * vmax, f"{label}: the library call disagrees: {res['library_max_abs_err']}")
            res["library_ms"] = event_ms(sdpa, 2, 10)
            del bias, lib
            line += f", library sdpa {res['library_ms']:.4f} ms + {res['library_bias_ms']:.4f} ms to build its bias"
        log(line)
    return res


def folded_bias_ms(args, scale, chunk, fetched_ms):
    """The other way to the bias at the global shape: the wgmma kernel with
    the bias folded into the first product, held to the plain version like
    the kernel the shape takes, and timed beside it."""
    from detectron2_tpu_torch.ops import attention as A

    folded = A.flash_attention_folded_cuda
    r = compare_attention(args, scale, False, chunk, "global standard bf16, bias folded into q.k^T", entry=(folded, A.attention_plain))
    check(r["path"] == "wgmma_folded", f"took the {r['path']} kernel")
    ms = event_ms(lambda: folded(*args, scale=scale), 2, 10)
    log(f"    bias folded into the first product {ms:.4f} ms, bias added to the scores (the kernel this shape takes) {fetched_ms:.4f} ms")
    return ms


def phase_attention_vs_plain(device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    results = {False: {}, True: {}}
    for name, (B, S, D, Hk, Wk) in ATTN_SHAPES.items():
        q, k, v = (torch.randn(B, S, D, generator=gen, device=device) for _ in range(3))
        rel_h = torch.randn(B, S, Hk, generator=gen, device=device) * 0.5
        rel_w = torch.randn(B, S, Wk, generator=gen, device=device) * 0.5
        log(f"  shape {name}: q, k, v {[B, S, D]}, factors {[B, S, Hk]} and {[B, S, Wk]}")
        for transposed in (False, True):
            h, w = (rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous()) if transposed else (rel_h, rel_w)
            for dtype in (torch.float32, torch.bfloat16):
                for bias in (True, False):
                    args = tuple(a.to(dtype) for a in (q, k, v)) + ((h.to(dtype), w.to(dtype)) if bias else (None, None))
                    timing = dtype == torch.bfloat16  # without the bias: the kernel and its plain version only
                    r = compare_attention(
                        args, D**-0.5, transposed, ATTN_CHUNK[name],
                        f"{name} {'transposed' if transposed else 'standard'} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                        f"{'bias' if bias else 'no bias'}", timing,
                    )
                    want = "simt_f32" if dtype == torch.float32 else ATTN_MAIN_PATHS[name]
                    check(r["path"] == want, f"{name} {dtype}: took the {r['path']} kernel, expected {want}")
                    if timing and bias:
                        results[transposed][name] = r
                        if name == "global" and not transposed:
                            r["folded_bias_ms"] = folded_bias_ms(args, D**-0.5, ATTN_CHUNK[name], r["ms"])
                    elif timing:
                        results[transposed][name]["no_bias_ms"] = r["ms"]
        del q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    # head dim 80 (C1): with the bias, both layouts, float32 and bfloat16
    results["d80"] = {False: {}, True: {}}
    for name, (B, S, D, Hk, Wk) in ATTN_D80_SHAPES.items():
        q, k, v = (torch.randn(B, S, D, generator=gen, device=device) for _ in range(3))
        rel_h = torch.randn(B, S, Hk, generator=gen, device=device) * 0.5
        rel_w = torch.randn(B, S, Wk, generator=gen, device=device) * 0.5
        log(f"  shape {name}: q, k, v {[B, S, D]}, factors {[B, S, Hk]} and {[B, S, Wk]}")
        for transposed in (False, True):
            h, w = (rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous()) if transposed else (rel_h, rel_w)
            for dtype in (torch.float32, torch.bfloat16):
                args = tuple(a.to(dtype) for a in (q, k, v, h, w))
                dname = str(dtype).split(".")[-1]
                r = compare_attention(
                    args, D**-0.5, transposed, ATTN_D80_CHUNK[name],
                    f"{name} {'transposed' if transposed else 'standard'} {dname} bias", dtype == torch.bfloat16,
                )
                want = ATTN_D80_PATHS[dname]
                check(r["path"] == want, f"{name} {dtype}: took the {r['path']} kernel, expected {want}")
                if dtype == torch.bfloat16:
                    results["d80"][transposed][name] = r
        del q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    return results


def detections_agree(a, b, iou_thresh=0.9, score_tol=0.01):
    """Share of a's valid detections (over the batch) that b holds too: same
    class, IoU >= iou_thresh, score within score_tol."""
    import torch

    from detectron2_tpu_torch.ops.nms import pairwise_iou

    found = total = 0
    for i in range(a["valid"].shape[0]):
        va, vb = a["valid"][i], b["valid"][i]
        iou = pairwise_iou(a["pred_boxes"][i][va][None], b["pred_boxes"][i][vb][None])[0]
        same = a["pred_classes"][i][va][:, None] == b["pred_classes"][i][vb][None, :]
        close = (a["scores"][i][va][:, None] - b["scores"][i][vb][None, :]).abs() <= score_tol
        found += int(((iou >= iou_thresh) & same & close).any(dim=1).sum().item())
        total += int(va.sum().item())
    return found / max(total, 1)


def phase_vitdet(device):
    import torch

    import detectron2_tpu_torch.modeling.backbone.vit as vit
    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import init_weights
    from detectron2_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_t_cuda
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    model = model_zoo.mask_rcnn_vitdet_b(device, compute_dtype="bfloat16", mask_paste_in_graph=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  Mask R-CNN ViTDet-B, {n_params} parameters, bf16 compute, in-graph paste")
    images = torch.randint(0, 256, (VIT_B, VIT_HW, VIT_HW, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[VIT_HW, VIT_HW]] * VIT_B, dtype=torch.int32, device=device)}
    counters = (flash_attention_cuda, flash_attention_t_cuda, roi_align_multilevel_cuda)

    def reset():
        for c in counters:
            c.launches = 0
        flash_attention_cuda.paths, flash_attention_t_cuda.paths = {}, {}

    def main_paths(forwards):
        """The kernels `forwards` ViTDet-B forwards must have taken."""
        return {ATTN_MAIN_PATHS[n]: ATTN_PER_FORWARD[n] * forwards for n in ATTN_SHAPES}

    def forward_recording():
        """One forward that keeps the attention inputs of the first windowed
        and the first global block and both pooler inputs."""
        attn_rec, pool_rec = {}, []
        attn_entry, pool_entry = vit.attention_with_rel_pos, poolers.roi_align_multilevel

        def rec_attn(q, k, v, rel_h, rel_w, *, scale, factors_transposed):
            name = "global" if q.shape[1] == ATTN_SHAPES["global"][1] else "windowed"
            attn_rec.setdefault(name, ((q, k, v, rel_h, rel_w), scale, factors_transposed))
            return attn_entry(q, k, v, rel_h, rel_w, scale=scale, factors_transposed=factors_transposed)

        def rec_pool(*args, **kwargs):
            pool_rec.append((args, kwargs))
            return pool_entry(*args, **kwargs)

        vit.attention_with_rel_pos, poolers.roi_align_multilevel = rec_attn, rec_pool
        try:
            out = model(batch)
        finally:
            vit.attention_with_rel_pos, poolers.roi_align_multilevel = attn_entry, pool_entry
        torch.cuda.synchronize()
        return out, attn_rec, pool_rec

    # (a) 4 batch forwards, the first one recorded
    os.environ.pop("D2T_FLASH_V2", None)
    iters = 3
    torch.cuda.reset_peak_memory_stats()
    reset()
    out, attn_rec, pool_rec = forward_recording()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = model(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch_launches = [c.launches for c in counters]
    check(batch_launches == [12 * (1 + iters), 0, 2 * (1 + iters)], f"launches over {1 + iters} forwards: {batch_launches}")
    batch_paths = dict(flash_attention_cuda.paths)
    check(batch_paths == main_paths(1 + iters), f"attention kernels taken over {1 + iters} forwards: {batch_paths}")
    log(f"  batch forward {VIT_B}x{VIT_HW}x{VIT_HW}: {dt * 1e3:.1f} ms/batch, {VIT_B / dt:.2f} img/s, peak memory {peak:.2f} GiB")
    log(f"  launches over {1 + iters} batch forwards: attention {batch_launches[0]} (12 per forward: {batch_paths}), "
        f"RoIAlign {batch_launches[2]} (2 per forward)")
    D = model.roi_heads.box_predictor.test_topk_per_image
    check(out["pred_boxes"].shape == (VIT_B, D, 4) and out["pred_masks"].shape == (VIT_B, D, 28, 28))
    check(out["pred_masks_full"].shape == (VIT_B, D, VIT_HW, VIT_HW) and out["pred_masks_full"].dtype == torch.bool)
    check(torch.isfinite(out["pred_boxes"]).all() and torch.isfinite(out["pred_masks"]).all())
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    log(f"  detections per image: {n_valid}")

    if "--profile" in sys.argv[1:]:
        profile_run(lambda: model(batch), "ViTDet forward", "vitdet_forward_trace.json")

    # (b) 3 requests of differing sizes through the predictor
    predictor = DefaultPredictor(model=model, min_size_test=VIT_HW, max_size_test=VIT_HW)
    rng = np.random.RandomState(0)
    reset()
    for h, w in ((480, 640), (600, 800), (427, 1000)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(len(inst) > 0, "no detections")
        check_instances(inst, len(inst), h, w)
        log(f"  request {h}x{w}: {len(inst)} instances, masks {tuple(inst.pred_masks.tensor.shape)}, {ms:.1f} ms")
    request_launches = [c.launches for c in counters]
    check(request_launches == [12 * 3, 0, 2 * 3], f"launches over 3 requests: {request_launches}")
    request_paths = dict(flash_attention_cuda.paths)
    check(request_paths == main_paths(3), f"attention kernels taken over 3 requests: {request_paths}")

    # (c) one forward with the transposed factor layout
    os.environ["D2T_FLASH_V2"] = "1"
    try:
        reset()
        out_t, attn_rec_t, _ = forward_recording()
    finally:
        os.environ.pop("D2T_FLASH_V2", None)
    t_launches = [c.launches for c in counters]
    check(t_launches == [0, 12, 2], f"launches of the transposed-layout forward: {t_launches}")
    t_paths = dict(flash_attention_t_cuda.paths)
    check(t_paths == main_paths(1), f"attention kernels taken by the transposed-layout forward: {t_paths}")
    agree = detections_agree(out, out_t)
    log(f"  transposed layout: {t_launches[1]} launches of the transposed kernel; {agree:.1%} of the standard layout's "
        f"detections found again (same class, IoU >= 0.9, score within 0.01: both run in bf16)")
    check(agree >= 0.9, f"the two layouts' detections differ: {agree}")
    del out_t

    # (d) the kernels against their plain versions on the main path's inputs
    attn = {False: {}, True: {}}
    for rec in (attn_rec, attn_rec_t):
        check(sorted(rec) == ["global", "windowed"], sorted(rec))
        for name, (args, scale, transposed) in rec.items():
            check(tuple(args[0].shape) == ATTN_SHAPES[name][:3] and args[0].dtype == torch.bfloat16, args[0].shape)
            r = compare_attention(
                args, scale, transposed, ATTN_CHUNK[name],
                f"main-path {name} block {'transposed' if transposed else 'standard'} bf16", timing=True,
            )
            check(r["path"] == ATTN_MAIN_PATHS[name], f"main-path {name}: took the {r['path']} kernel")
            log(f"    {PREV_ATTN_MS[transposed][name]:.4f} ms on {PREV_MS_FROM}: "
                f"{PREV_ATTN_MS[transposed][name] / r['ms']:.2f}x")
            attn[transposed][name] = r
    check(len(pool_rec) == 2, len(pool_rec))
    pools = {}
    for (args, kwargs), res in zip(pool_rec, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        pools[res] = compare_kernel(
            feats, boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"],
            f"ViTDet pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["vitdet"][res],
        )
    return {
        "vitdet_img_s": VIT_B / dt,
        "vitdet_batch_ms": dt * 1e3,
        "vitdet_peak_gib": peak,
        "attn_launches": batch_launches[0] + request_launches[0],
        "attn_t_launches": t_launches[1],
        "attn_paths": {k: batch_paths[k] + request_paths[k] for k in batch_paths},
        "attn_t_paths": t_paths,
        "roi_launches": batch_launches[2] + request_launches[2] + t_launches[2],
        "attn": attn,
        "pools": pools,
    }


def instances_agree(a, b) -> dict:
    """One image's Instances from two paths: classes equal, boxes within
    1e-3 px, scores within 1e-4, masks equal on at least 99.9% of pixels."""
    import torch

    check(len(a) == len(b), f"{len(a)} vs {len(b)} instances")
    check(torch.equal(a.pred_classes, b.pred_classes), "classes differ")
    box_err = (a.pred_boxes.tensor - b.pred_boxes.tensor).abs().max().item() if len(a) else 0.0
    score_err = (a.scores - b.scores).abs().max().item() if len(a) else 0.0
    same = (a.pred_masks.tensor == b.pred_masks.tensor).float().mean().item() if len(a) else 1.0
    check(box_err <= 1e-3 and score_err <= 1e-4 and same >= 0.999, (box_err, score_err, same))
    return {"n": len(a), "box_err": box_err, "score_err": score_err, "mask_agree": same}


def phase_eval(device, state_dict, card: str, workdir: str):
    """``tools/train_net.py --eval-only`` on the port: a synthetic COCO json
    registered by name, the test loader, the R50-FPN 3x zoo config in bf16
    with phase 5's seeded weights and FrozenBN statistics,
    ``DefaultTrainer.test`` with COCOEvaluator. The dataset stays in
    ``workdir`` for phase 11."""
    from detectron2_tpu_torch.testing import write_synthetic_coco

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    json_file, image_root = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
    write_s = time.perf_counter() - t0
    res = _eval_on(device, state_dict, card, json_file, image_root, write_s)
    res["coco"] = (json_file, image_root)
    res["eval_phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 took {res['eval_phase_s']:.1f} s")
    return res


def _eval_on(device, state_dict, card, json_file, image_root, write_s):
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import MetadataCatalog, build_detection_test_loader
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.engine import DefaultPredictor, DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import COCO_SIZES, ground_truth_detections

    name = "chip_smoke_synthetic_coco"
    register_coco_instances(name, {}, json_file, image_root)
    cfg = model_zoo.get_config(EVAL_CONFIG)
    cfg.MODEL.WEIGHTS = ""  # phase 5's seeded weights instead
    cfg.DATASETS.TEST = (name,)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.OUTPUT_DIR = ""
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    n_gt = sum(1 for _ in ground_truth_detections(json_file))
    log(f"  {EVAL_IMAGES} images of {list(COCO_SIZES)} (h, w), "
        f"{n_gt} non-crowd objects over 80 categories, written in {write_s:.2f} s; config {EVAL_CONFIG}, "
        f"MIN_SIZE_TEST {cfg.INPUT.MIN_SIZE_TEST}, MAX_SIZE_TEST {cfg.INPUT.MAX_SIZE_TEST}, bf16")

    # the eval run: the kernel's counts from 0 just before, read just after;
    # the first batch's pooler inputs are recorded for the comparison below
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    evaluator = COCOEvaluator(name, distributed=False)
    evaluate = evaluator.evaluate
    evaluate_s = []

    def timed_evaluate(*args, **kwargs):
        t = time.perf_counter()
        out = evaluate(*args, **kwargs)
        evaluate_s.append(time.perf_counter() - t)
        return out

    evaluator.evaluate = timed_evaluate
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_cuda.paths = {}
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 2)
    t0 = time.perf_counter()
    try:
        results = DefaultTrainer.test(cfg, model, evaluators=[evaluator], timing=timing)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    test_s = time.perf_counter() - t0
    launches, paths = roi_align_multilevel_cuda.launches, dict(roi_align_multilevel_cuda.paths)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = timing[name]

    # 1. every metric the csv table prints, finite, in [0, 100]
    check(set(results) == {"bbox", "segm"}, list(results))
    for task in ("bbox", "segm"):
        values = [results[task][k] for k in EVAL_KEYS]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        log(f"  {task}: " + ", ".join(EVAL_KEYS))
        log(f"  {task}: " + ", ".join(f"{v:.4f}" for v in values))
    # 2. both pools of every batch through the kernel, on its 16-byte path
    check(launches == 2 * t["batches"], f"{launches} RoIAlign launches over {t['batches']} batches")
    check(paths == {"vector": launches}, paths)
    timed = t["timed_batches"]
    img_s = timed / t["total_s"]
    log(f"  {card}: {t['batches']} batches of 1 image, RoIAlign launches {launches} {paths}")
    log(f"  eval loop {img_s:.2f} img/s over the {timed} batches after the first 2: per image data "
        f"{t['data_s'] / timed:.4f} s, compute {t['compute_s'] / timed:.4f} s, evaluator.process "
        f"{t['eval_s'] / timed:.4f} s; evaluator.evaluate (COCOeval, bbox + segm) {evaluate_s[0]:.2f} s; "
        f"DefaultTrainer.test {test_s:.2f} s; peak memory {peak:.2f} GiB")

    # 3. the ground truth fed back as detections: AP 100 (the PIL-free PNG
    # codec and the cv2-free polygon fill on this machine)
    contiguous = MetadataCatalog.get(name).thing_dataset_id_to_contiguous_id
    perfect = COCOEvaluator(name, distributed=False)
    by_image = {}
    for det in ground_truth_detections(json_file):
        det["category_id"] = contiguous[det["category_id"]]
        by_image.setdefault(det["image_id"], []).append(det)
    perfect._predictions = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    perfect_res = perfect.evaluate()
    for task in ("bbox", "segm"):
        check(perfect_res[task]["AP"] == 100.0, (task, perfect_res[task]))
    log(f"  ground truth as detections: bbox AP {perfect_res['bbox']['AP']}, segm AP {perfect_res['segm']['AP']}")

    # 4. the eval path and DefaultPredictor on the same four images
    predictor = DefaultPredictor(
        model=model, min_size_test=cfg.INPUT.MIN_SIZE_TEST, max_size_test=cfg.INPUT.MAX_SIZE_TEST,
        size_bucket=cfg.TPU.SIZE_BUCKET,
    )
    agree = []
    for i, batch in enumerate(build_detection_test_loader(cfg, name)):
        if i == 4:
            break
        meta = batch["metadata"][0]
        out = model({k: v for k, v in batch.items() if k != "metadata"})
        in_h, in_w = batch["image_sizes"][0].tolist()
        with torch.inference_mode():
            ours = detector_postprocess({k: v[0] for k, v in out.items()}, meta["height"], meta["width"], in_h, in_w)
        theirs = predictor(read_image(meta["file_name"], "BGR"))["instances"]
        agree.append(instances_agree(ours, theirs))
    log(f"  eval path vs DefaultPredictor on 4 images: {agree}")

    # 5. the kernel against the plain version on the eval path's own inputs
    # (the first batch's box and mask pools), in bf16 as run and in float32
    check(len(recorded) == 2, len(recorded))
    pools = {}
    for (args, kwargs), res in zip(recorded, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        sr, aligned = kwargs["sampling_ratio"], kwargs["aligned"]
        label = f"eval-path pool R={boxes.shape[0]} {res}x{res}"
        pools[res] = compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, label + " bf16", timing=True)
        f32 = compare_kernel([f.float() for f in feats], boxes, bidx, levels, scales, res, sr, aligned, label + " f32")
        pools[res]["max_abs_err_f32"] = f32["max_abs_err"]
    return {
        "eval_img_s": img_s,
        "eval_data_s_per_img": t["data_s"] / timed,
        "eval_compute_s_per_img": t["compute_s"] / timed,
        "eval_process_s_per_img": t["eval_s"] / timed,
        "eval_evaluate_s": evaluate_s[0],
        "eval_peak_gib": peak,
        "eval_bbox_AP": results["bbox"]["AP"],
        "eval_segm_AP": results["segm"]["AP"],
        "roi_launches": launches,
        "roi_paths": paths,
        "pools": pools,
    }


def first_images(json_file: str, n: int, out_file: str) -> str:
    """A COCO json of the first ``n`` images of ``json_file`` and their
    annotations."""
    with open(json_file) as f:
        coco = json.load(f)
    images = coco["images"][:n]
    ids = {im["id"] for im in images}
    coco.update(images=images, annotations=[a for a in coco["annotations"] if a["image_id"] in ids])
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return out_file


def recording_pools(poolers, recorded, n: int = 2):
    """A stand-in for ``poolers.roi_align_multilevel`` that records the
    first ``n`` calls' inputs (a training step's pools: box and mask by
    default) and the cotangents that reach their outputs."""
    import torch

    kernel_entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        out = kernel_entry(*args, **kwargs)
        if len(recorded) < n:
            rec = {"args": args, "kwargs": kwargs}
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone(memory_format=torch.contiguous_format)))
            recorded.append(rec)
        return out

    return recording


def compare_recorded_pools(recorded, label, keys=(BOX_RES, MASK_RES)):
    """Both kernels against their plain versions on a training step's
    recorded pools: the forward in the dtype it ran in (timed) and, for a
    bf16 run, in float32 as well; the backward on the cotangent (scaled
    exactly, by a power of two, to a max in [1, 2)) the same way. Keyed by
    ``keys``, one per pool in launch order (BOX_RES for the box pool and
    MASK_RES for the mask pool, as the other phases' results, by default),
    with the pool's own resolution under "res"."""
    import torch

    check(len(recorded) == len(keys) and all("grad" in r for r in recorded), len(recorded))
    fwd, bwd = {}, {}
    with torch.no_grad():
        for rec, key in zip(recorded, keys):
            feats, boxes, bidx, levels, scales, (res, res_w) = rec["args"]
            check(res == res_w, rec["args"][5])
            feats = [f.detach() for f in feats]
            dtype = "bf16" if feats[0].dtype == torch.bfloat16 else "f32"
            sr, aligned = rec["kwargs"]["sampling_ratio"], rec["kwargs"]["aligned"]
            pool = f"{label} pool R={boxes.shape[0]} {res}x{res} over {len(feats)} levels"
            fwd[key] = compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, f"{pool} {dtype}", timing=True)
            g = rec["grad"]
            g_max = g.float().abs().max().item()
            check(g_max > 0, f"{pool}: the step's cotangent is zero")
            g = g * 2.0 ** -math.floor(math.log2(g_max))
            shapes = [tuple(f.shape) for f in feats]
            scaled = f"cotangent x 2^{-math.floor(math.log2(g_max))}"
            bwd[key] = compare_backward(
                g, shapes, boxes, bidx, levels, scales, res, sr, aligned, f"{pool} bwd {dtype} ({scaled})", timing=True
            )
            if dtype == "bf16":
                f32 = compare_kernel([f.float() for f in feats], boxes, bidx, levels, scales, res, sr, aligned, pool + " f32")
                fwd[key]["max_abs_err_f32"] = f32["max_abs_err"]
                f32 = compare_backward(
                    g.float(), shapes, boxes, bidx, levels, scales, res, sr, aligned, f"{pool} bwd f32 ({scaled})"
                )
                bwd[key]["max_abs_err_f32"] = f32["max_abs_err"]
            fwd[key]["res"] = bwd[key]["res"] = res
            check(bwd[key]["path"] == "vector", f"{pool}: the backward took the {bwd[key]['path']} path")
    recorded.clear()
    return fwd, bwd


def zoo_train_config(config_name: str, train_name: str, test_name: str, output_dir: str, iters: int,
                     min_sizes=(640, 672, 704, 736, 768, 800), sampler: str = "TrainingSampler", max_size: int = 1333,
                     ims_per_batch: int = 16):
    """A zoo yaml at its own training input (checked: ``ims_per_batch``
    images a step, ``min_sizes`` / ``max_size``, flips, grouping,
    ``sampler``), bf16, with the
    smoke run's cuts, listed in PERF.md section 4: ``iters`` steps, warmup
    over 100 (the 3x warmup's first LRs move some heads by less than a
    float32 ulp), gradients clipped to a global norm of 1 (seeded weights
    give gradients of 1e2-1e3 and the losses diverge within 10 steps even
    at the warmup's first LRs), one evaluation after training at score
    threshold 0, SEED 0."""
    from detectron2_tpu_torch import model_zoo

    cfg = model_zoo.get_config(config_name)
    i, d = cfg.INPUT, cfg.DATALOADER
    check(
        (cfg.SOLVER.IMS_PER_BATCH, tuple(i.MIN_SIZE_TRAIN), i.MIN_SIZE_TRAIN_SAMPLING, i.MAX_SIZE_TRAIN, i.RANDOM_FLIP,
         d.ASPECT_RATIO_GROUPING, d.SAMPLER_TRAIN)
        == (ims_per_batch, tuple(min_sizes), "choice", max_size, "horizontal", True, sampler),
        f"{config_name}: the zoo yaml's training input",
    )
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.DATASETS.TRAIN = (train_name,)
    cfg.DATASETS.TEST = (test_name,)
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.WARMUP_ITERS = 10 * TRAIN_STEPS  # as phase 7
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # 20 steps leave few scores over 0.05
    cfg.SEED = 0
    cfg.OUTPUT_DIR = output_dir
    return cfg


def step_launches(per_step):
    """(forward, backward) kernel launches of each step, from the running
    counts ``per_step`` read after each step."""
    return [(f - pf, b - pb) for (f, b), (pf, pb) in zip(per_step, [(0, 0)] + per_step[:-1])]


def step_times(storage, ims_per_batch: int, card: str, peak_gib: float) -> dict:
    """The steps after IterationTimer's warmup of 3: median step time and
    data_time, img/s, the share of the step spent waiting on the loader;
    logged with every step's times and the peak memory."""
    times = dict((i, v) for v, i in storage.history("time").values())
    data = {i: v for v, i in storage.history("data_time").values() if i in times}
    timed = sorted(times)
    step_ms = float(np.median([times[i] for i in timed])) * 1e3
    data_ms = float(np.median([data[i] for i in timed])) * 1e3
    share = sum(data.values()) / sum(times[i] for i in timed)
    img_s = ims_per_batch / step_ms * 1e3
    log(f"  {card}: steps {timed[0] + 1}-{timed[-1] + 1}: median step {step_ms:.1f} ms, median data_time {data_ms:.1f} ms, "
        f"{img_s:.2f} img/s; waiting on the loader {share:.1%} of the step time; peak memory {peak_gib:.2f} GiB")
    log("  step times (ms): " + ", ".join(f"{times[i] * 1e3:.1f}" for i in timed))
    log("  data times (ms): " + ", ".join(f"{data[i] * 1e3:.1f}" for i in timed))
    return {"ms_per_step": step_ms, "data_ms_per_step": data_ms, "img_s": img_s, "data_share": share}


def phase_default_trainer(device, card: str, workdir: str, weights: str, coco):
    """``tools/train_net.py`` training on the port: DefaultTrainer over the
    registered synthetic COCO at the zoo yaml's full width and training
    input, from phase 7's checkpoint; then a resume."""
    import torch

    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.engine import DefaultTrainer, hooks
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    json_file, image_root = coco
    train_name, test_name = "chip_smoke_coco_train", "chip_smoke_coco_test16"
    register_coco_instances(train_name, {}, json_file, image_root)
    test_json = first_images(json_file, TRAINER_TEST_IMAGES, os.path.join(workdir, "test16.json"))
    register_coco_instances(test_name, {}, test_json, image_root)

    cfg = zoo_train_config(EVAL_CONFIG, train_name, test_name, os.path.join(workdir, "default_trainer"), TRAINER_ITERS)
    cfg.MODEL.WEIGHTS = weights
    cfg.SOLVER.CHECKPOINT_PERIOD = TRAINER_CKPT_PERIOD

    class SmokeTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, distributed=False)

        def build_hooks(self):
            ret = super().build_hooks()
            # metrics.json gets a line per step (the default writes every 20)
            check(isinstance(ret[-1], hooks.PeriodicWriter), ret[-1])
            ret[-1] = hooks.PeriodicWriter(self.build_writers(), period=1)
            return ret

    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    t0 = time.perf_counter()
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    build_s = time.perf_counter() - t0
    check(trainer.model.device.type == device.type, trainer.model.device)
    check(trainer.checkpointer.last_report.startswith("Loaded "), trainer.checkpointer.last_report)
    # phase 7 calibrated FrozenBN on its noise images; on these images those
    # statistics blow the activations up and the losses diverge within 20
    # steps, so they are calibrated again on 4 of the train images (a cut)
    calib = next(iter(build_detection_test_loader(cfg, train_name, batch_size=4)))
    calibrate_frozen_bn(trainer.model, {k: v for k, v in calib.items() if k != "metadata"})
    log(f"  {EVAL_CONFIG} bf16, {cfg.SOLVER.IMS_PER_BATCH} images a step, MIN_SIZE_TRAIN {tuple(cfg.INPUT.MIN_SIZE_TRAIN)} "
        f"({cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING}), MAX_SIZE_TRAIN {cfg.INPUT.MAX_SIZE_TRAIN}, flip {cfg.INPUT.RANDOM_FLIP}; "
        f"weights {os.path.basename(weights)}: {trainer.checkpointer.last_report.splitlines()[0]}; built in {build_s:.2f} s")
    recorded = []
    results, steps, train_s, peak = train_counted(trainer, recorded, 2)
    fwd_launches, bwd_launches, paths = fwd_k.launches, bwd_k.launches, dict(fwd_k.paths)

    # the kernels: twice a step each, then twice an eval batch (forward)
    check(len(steps) == TRAINER_ITERS, len(steps))
    check(all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    eval_launches = fwd_launches - sum(f for f, _ in steps)
    check(eval_launches == 2 * TRAINER_TEST_IMAGES, f"{eval_launches} forward launches over {TRAINER_TEST_IMAGES} eval batches")
    check(bwd_launches == 2 * TRAINER_ITERS, f"backward launches {bwd_launches}")
    check(paths == {"vector": fwd_launches}, paths)
    storage = trainer.storage
    for k in LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == TRAINER_ITERS and all(np.isfinite(values)), (k, values))
    log(f"  {TRAINER_ITERS} steps + evaluation in {train_s:.2f} s; RoIAlign launches forward {fwd_launches} "
        f"({2 * TRAINER_ITERS} in steps, {eval_launches} in {TRAINER_TEST_IMAGES} eval batches), backward {bwd_launches}")
    log("  total_loss: " + ", ".join(f"{v:.4f}" for v, _ in storage.history("total_loss").values()))

    # metrics.json: a line per step, then the evaluation's
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    step_lines = [x for x in lines if "total_loss" in x]
    check([x["iteration"] for x in step_lines] == list(range(TRAINER_ITERS)), [x["iteration"] for x in lines])
    for x in step_lines:
        missing = set(LOSSES) | {"lr", "data_time"} | ({"time"} if x["iteration"] >= 3 else set())
        check(missing <= set(x), (x["iteration"], sorted(x)))
    check(any("bbox/AP" in x and x["iteration"] == TRAINER_ITERS for x in lines), "the evaluation's line")
    ckpt_name = f"model_{TRAINER_CKPT_PERIOD - 1:07d}.pth"
    for name in (ckpt_name, f"model_{TRAINER_ITERS - 1:07d}.pth", "model_final.pth"):
        check(os.path.exists(os.path.join(cfg.OUTPUT_DIR, name)), name)
    check(set(results) == {"bbox", "segm"}, list(results))
    for task in ("bbox", "segm"):
        values = [results[task][k] for k in EVAL_KEYS]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        log(f"  EvalHook {task}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(EVAL_KEYS, values)))

    stats = step_times(storage, cfg.SOLVER.IMS_PER_BATCH, card, peak)

    fwd, bwd = compare_recorded_pools(recorded, "trainer first-batch")

    # resume from the checkpoint at TRAINER_CKPT_PERIOD: that iteration, equal state, one step
    ckpt = os.path.join(cfg.OUTPUT_DIR, ckpt_name)
    with open(os.path.join(cfg.OUTPUT_DIR, "last_checkpoint"), "w") as f:
        f.write(ckpt_name)
    cfg2 = cfg.clone()
    cfg2.SOLVER.MAX_ITER = TRAINER_CKPT_PERIOD + 1
    cfg2.DATASETS.TEST = ()
    second = SmokeTrainer(cfg2)
    second.resume_or_load(resume=True)
    check(second.start_iter == TRAINER_CKPT_PERIOD, second.start_iter)
    saved = torch.load(ckpt, map_location=device, weights_only=True)
    model_state = second.model.state_dict()
    check(all(torch.equal(model_state[k], v) for k, v in saved["model"].items()) and model_state.keys() == saved["model"].keys(),
          "the resumed model differs from the checkpoint")
    opt, ref = second.optimizer.state_dict(), saved["trainer"]["_trainer"]["optimizer"]
    check(opt["param_groups"] == ref["param_groups"] and opt["state"].keys() == ref["state"].keys(), "optimizer groups")
    check(all(torch.equal(opt["state"][j]["momentum_buffer"], ref["state"][j]["momentum_buffer"]) for j in ref["state"]),
          "the resumed momentum buffers differ from the checkpoint")
    check(all(v.device == device for v in model_state.values()), "a resumed tensor is off the card")
    fwd_k.launches = bwd_k.launches = 0
    second.train()
    torch.cuda.synchronize()
    check((fwd_k.launches, bwd_k.launches) == (2, 2), (fwd_k.launches, bwd_k.launches))
    check([i for _, i in second.storage.history("total_loss").values()] == [TRAINER_CKPT_PERIOD], "the resumed step")
    log(f"  resumed at iteration {second.start_iter} from {os.path.basename(ckpt)}: model ({len(model_state)} tensors) and "
        f"optimizer ({len(ref['state'])} momentum buffers) bitwise equal to the checkpoint; one step, total_loss "
        f"{second.storage.history('total_loss').latest():.4f}")
    del second, trainer
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 11 took {phase_s:.1f} s")
    return {
        **{f"trainer_{k}": v for k, v in stats.items()},
        "trainer_peak_gib": peak,
        "trainer_phase_s": phase_s,
        "trainer_bbox_AP": results["bbox"]["AP"],
        "trainer_segm_AP": results["segm"]["AP"],
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }


def gate_setup(workdir: str, keypoints: bool = False):
    """A train->AP gate's 16 images, registered (the keypoint gate's with
    its corner keypoint names and no flip pairs), its config (``SEED`` 0,
    so that the loader draws reproducibly) and its trainer class."""
    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.engine import DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.testing import (
        OVERFIT_KEYPOINT_NAMES,
        overfit_config,
        overfit_keypoint_config,
        write_synthetic_overfit_coco,
    )

    name = "chip_smoke_overfit_keypoints" if keypoints else "chip_smoke_overfit"
    root = os.path.join(workdir, "overfit_keypoints" if keypoints else "overfit")
    json_file, image_dir = write_synthetic_overfit_coco(root, keypoints=keypoints)
    register_coco_instances(name, {}, json_file, image_dir)
    if keypoints:
        MetadataCatalog.get(name).set(keypoint_names=OVERFIT_KEYPOINT_NAMES, keypoint_flip_map=())
    cfg = (overfit_keypoint_config if keypoints else overfit_config)(os.path.join(root, "output"), name)
    cfg.SEED = 0

    class GateTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, output_dir=os.path.join(cfg.OUTPUT_DIR, "eval"), distributed=False,
                                 kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS)

    return cfg, GateTrainer


def gate_determinism(device, workdir: str, iters: int = GATE_REPRO_ITERS):
    """Where the gate's runs stop being reproducible: ``iters`` steps of its
    config, twice under each setting (as phase 12 runs, with cuDNN's
    deterministic algorithms, and with ``torch.use_deterministic_algorithms
    (True, warn_only=True)``, whose warnings name each operation that has no
    deterministic implementation); per setting the first step whose losses
    differ between the two runs and the parameters that differ after the
    last step."""
    import warnings

    import torch

    cfg, GateTrainer = gate_setup(workdir)
    cfg.SOLVER.MAX_ITER = iters
    cfg.DATASETS.TEST = ()
    cfg.TEST.EXPECTED_RESULTS = []

    def run(tag):
        c = cfg.clone()
        c.OUTPUT_DIR = os.path.join(workdir, "repro", tag)
        trainer = GateTrainer(c)
        trainer.resume_or_load(resume=False)
        trainer.train()
        torch.cuda.synchronize()
        losses = [[v for v, _ in trainer.storage.history(k).values()] for k in LOSSES]
        return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}

    settings = ("as phase 12", "cudnn.deterministic", "use_deterministic_algorithms")
    out = {}
    for setting in settings:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.backends.cudnn.deterministic = setting == "cudnn.deterministic"
            torch.use_deterministic_algorithms(setting == "use_deterministic_algorithms", warn_only=True)
            try:
                (la, sa), (lb, sb) = run(setting + " a"), run(setting + " b")
            finally:
                torch.backends.cudnn.deterministic = False
                torch.use_deterministic_algorithms(False)
        first = next((i for i, step in enumerate(zip(*la, *lb)) if step[:len(LOSSES)] != step[len(LOSSES):]), None)
        differ = sorted(k for k in sa if not torch.equal(sa[k], sb[k]))
        nondet = sorted({str(w.message).split(" does not have a deterministic")[0][:120]
                         for w in caught if "deterministic" in str(w.message)})
        log(f"  {setting}: {iters} steps twice; first step whose losses differ: {first}; "
            f"{len(differ)} of {len(sa)} tensors differ after the last step ({', '.join(differ[:4])}"
            f"{', ...' if len(differ) > 4 else ''}); operations without a deterministic version: {nondet or 'none'}")
        out[setting] = {"first_differing_step": first, "tensors_differ": len(differ), "nondeterministic_ops": nondet}
    return out


def phase_train_to_ap(device, card: str, workdir: str, keypoints: bool = False):
    """The JAX package's train->AP gate on the card, through the port's
    DefaultTrainer: synthetic rectangles, the overfit config, 500 steps,
    one evaluation, verify_results and the test's floors; with
    ``keypoints`` its keypoint gate (corner keypoints, a keypoint head)."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    cfg, GateTrainer = gate_setup(workdir, keypoints)
    floors = KEYPOINT_GATE_FLOORS if keypoints else GATE_FLOORS
    trainer = GateTrainer(cfg)
    trainer.resume_or_load(resume=False)
    check(trainer.model.device.type == device.type, trainer.model.device)
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    torch.cuda.synchronize()
    roi_align_multilevel_cuda.launches = roi_align_multilevel_backward_cuda.launches = 0
    roi_align_multilevel_cuda.paths = {}
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    t0 = time.perf_counter()
    try:
        results = trainer.train()  # verify_results exits non-zero outside the bands
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = roi_align_multilevel_cuda.launches, roi_align_multilevel_backward_cuda.launches
    paths = dict(roi_align_multilevel_cuda.paths)
    n_iter, n_test = cfg.SOLVER.MAX_ITER, 16
    check(n_iter == 500, n_iter)
    check(bwd_launches == 2 * n_iter, f"backward launches {bwd_launches}")
    check(fwd_launches == 2 * n_iter + 2 * n_test, f"forward launches {fwd_launches}")
    check(paths == {"vector": fwd_launches}, paths)
    tasks = [task for task, *_ in cfg.TEST.EXPECTED_RESULTS]
    aps = {task: results[task]["AP"] for task in tasks}
    for task, metric, expected, tol in cfg.TEST.EXPECTED_RESULTS:
        check(abs(results[task][metric] - expected) <= tol, f"{task} {metric} {results[task][metric]} outside {expected} +- {tol}")
    for task, floor in floors.items():
        check(aps[task] >= floor, f"{task} AP {aps[task]} < {floor}")
    step_ms = trainer.storage.history("time").median(n_iter) * 1e3
    bands = {task: f"{expected} +- {tol}" for task, _, expected, tol in cfg.TEST.EXPECTED_RESULTS}
    log(f"  {card}: {n_iter} steps of {cfg.SOLVER.IMS_PER_BATCH} x 64x64 float32 + evaluation in {wall_s:.2f} s "
        f"(median step {step_ms:.2f} ms); " + ", ".join(
            f"{task} AP {ap:.4f} ({bands[task]}{f', floor {floors[task]}' if task in floors else ''})" for task, ap in aps.items())
        + f"; RoIAlign launches forward {fwd_launches}, backward {bwd_launches}")
    log("  total_loss at steps 1, 100, 200, 300, 400, 500: " + ", ".join(
        f"{v:.4f}" for v, i in trainer.storage.history("total_loss").values() if i in (0, 99, 199, 299, 399, 499)))
    keys = ("box", "keypoint") if keypoints else (BOX_RES, MASK_RES)
    fwd, bwd = compare_recorded_pools(recorded, f"{'keypoint ' if keypoints else ''}gate first-batch", keys=keys)
    prefix = "kpt_gate_" if keypoints else "gate_"
    return {
        **{f"{prefix}{task}_AP": ap for task, ap in aps.items()},
        f"{prefix}wall_s": wall_s,
        f"{prefix}ms_per_step": step_ms,
        f"{prefix}phase_s": time.perf_counter() - t_phase,
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }


# ---------------------------------------------------------------- phases 13-17
# the zoo configs of the other R-CNN heads, and what their paths pool
KPT_CONFIG = "COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml"
C4_CONFIG = "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml"
CASCADE_CONFIG = "Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml"
C4_C, C4_STRIDE = 1024, 16  # res4 of the R50: 1024 channels at stride 16
HEAD_FORWARDS = 3  # timed batch forwards per model, after one that records the pools
KPT_EVAL_IMAGES = 24
KPT_EVAL_KEYS = ("AP", "AP50", "AP75", "APm", "APl")
TTA_IMAGES = 1  # 2 until phases 39-40 came
# pools per forward and their names, in launch order
HEAD_POOLS = {
    "keypoint": ("box", "keypoint"),
    "c4": ("box", "mask"),
    "cascade": ("box stage 1", "box stage 2", "box stage 3", "mask"),
}


def phase_new_shapes(device):
    """B1 against its plain version at the shapes phases 14-16 give it:
    the C4 box and mask pools (one level, res4 of 16 x 800x1344, 1024
    channels, 14x14 at s = 2), the keypoint pool (1600 rois, 14x14 over
    p2-p5) and a cascade stage's box pool (16000 rois, 7x7 over p2-p5)."""
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    fpn32 = [torch.randn(B, H // s, W // s, C, generator=gen, device=device) for s in STRIDES]
    res4_32 = [torch.randn(B, H // C4_STRIDE, W // C4_STRIDE, C4_C, generator=gen, device=device)]
    cases = (
        ("c4 box", res4_32, BOX_ROIS, MASK_RES),
        ("c4 mask", res4_32, MASK_ROIS, MASK_RES),
        ("keypoint", fpn32, MASK_ROIS, MASK_RES),
        ("cascade box", fpn32, BOX_ROIS, BOX_RES),
    )
    results = {}
    for name, feats32, n, res in cases:
        boxes, bidx = synthetic_rois(gen, n, device, batch=B)
        if len(feats32) == 1:
            scales, levels = (1.0 / C4_STRIDE,), torch.zeros(boxes.shape[0], dtype=torch.int32, device=device)
        else:
            scales, levels = tuple(1.0 / s for s in STRIDES), assign_boxes_to_levels(boxes, 2, 5)
        feats16 = [f.to(torch.bfloat16) for f in feats32]
        log(f"  {name}: {boxes.shape[0]} rois at {res}x{res} over {[tuple(f.shape) for f in feats16]}")
        for dtype, feats in (("f32", feats32), ("bf16", feats16)):
            r = compare_kernel(
                feats, boxes, bidx, levels, scales, res, 0, True, f"{name} R={boxes.shape[0]} {res}x{res} {dtype}",
                timing=dtype == "bf16", vector=True,
            )
            if dtype == "bf16":
                results[name] = r
        if len(feats32) == 1:  # the v1 grid at 1024 channels too
            compare_kernel(feats16, boxes, bidx, levels, scales, res, 2, False, f"{name} {res}x{res} bf16 aligned=False sr=2")
        del feats16
    return results


def seeded_zoo_model(device, config_name: str, score_thresh: float = 0.0, edit=None):
    """DefaultPredictor of a zoo yaml in bf16 with seeded weights and FrozenBN
    calibrated on two noise images of the batch, and that 16 x 800x1344
    batch. ``SCORE_THRESH_TEST`` 0 keeps DETECTIONS_PER_IMAGE detections
    per image, so the mask and keypoint pools run at full width; ``edit``
    changes the config further before the model is built."""
    import torch

    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights

    cfg = model_zoo.get_config(config_name)
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = score_thresh
    if edit is not None:
        edit(cfg)
    predictor = DefaultPredictor(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(predictor.model, gen)
    images = torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[H, W]] * B, dtype=torch.int32, device=device)}
    calibrate_frozen_bn(predictor.model, {k: v[:2] for k, v in batch.items()})
    n_params = sum(p.numel() for p in predictor.model.parameters())
    log(f"  {config_name}: {n_params} parameters, bf16, {cfg.MODEL.META_ARCHITECTURE}, ROI heads {cfg.MODEL.ROI_HEADS.NAME}, "
        f"SCORE_THRESH_TEST {score_thresh}")
    return cfg, predictor, batch


def recording_entry(poolers, recorded, n):
    """A stand-in for ``poolers.roi_align_multilevel`` that records the
    inputs of its first ``n`` calls."""
    kernel_entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        if len(recorded) < n:
            recorded.append((args, kwargs))
        return kernel_entry(*args, **kwargs)

    return recording


def compare_pools(recorded, names, label):
    """B1 against its plain version on recorded pooler inputs, timed."""
    out = {}
    for (args, kwargs), name in zip(recorded, names):
        feats, boxes, bidx, levels, scales, (res, _) = args
        out[name] = compare_kernel(
            feats, boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"],
            f"{label} {name} pool R={boxes.shape[0]} {res}x{res} over {len(feats)} level(s), C={feats[0].shape[-1]}",
            timing=True, vector=True,
        )
        out[name]["res"] = res
    recorded.clear()
    return out


def check_keypoints(inst, n, h, w, k=17) -> None:
    """One request's keypoints: [n, K, 3] (x, y, prob), inside the image's
    frame up to a pixel, probabilities in (0, 1]."""
    import torch

    kp = inst.pred_keypoints
    check(kp.shape == (n, k, 3) and torch.isfinite(kp).all(), tuple(kp.shape))
    check((kp[..., 0] >= -1).all() and (kp[..., 0] <= w + 1).all() and (kp[..., 1] >= -1).all()
          and (kp[..., 1] <= h + 1).all(), "keypoints outside the image")
    check((kp[..., 2] > 0).all() and (kp[..., 2] <= 1).all(), "keypoint probabilities")


def nms_timed_forward(model, batch):
    """One forward with every NMS call timed on the host between two
    synchronisations: ms, calls and fixpoint rounds of the RPN's NMS and of
    the box head's (per-class) NMS. Its B1 launches come after the path's
    counts were read."""
    import torch

    import detectron2_tpu_torch.modeling.proposal_generator.proposal_utils as proposal_utils
    import detectron2_tpu_torch.modeling.roi_heads.fast_rcnn as fast_rcnn
    from detectron2_tpu_torch.ops.nms import nms_padded

    out = {"rpn": {"ms": 0.0, "calls": 0, "rounds": 0}, "box head": {"ms": 0.0, "calls": 0, "rounds": 0}}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            rounds, t0 = nms_padded.rounds, time.perf_counter()
            keep = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec = out[key]
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            rec["rounds"] += nms_padded.rounds - rounds
            return keep

        return run

    rpn_nms, box_nms = proposal_utils.nms_padded, fast_rcnn.batched_nms_padded
    proposal_utils.nms_padded, fast_rcnn.batched_nms_padded = timed("rpn", rpn_nms), timed("box head", box_nms)
    try:
        model(batch)
    finally:
        proposal_utils.nms_padded, fast_rcnn.batched_nms_padded = rpn_nms, box_nms
    return out


def phase_heads(device, name: str, config_name: str):
    """One zoo model of phases 14-16 at full width: the predictor on one
    image (first and steady call), then one batch forward at 16 x 800x1344
    that records the pools and HEAD_FORWARDS timed ones; B1's launches per
    forward, the NMS loop's rounds, the peak memory; B1 held to its plain
    version on the recorded pools."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.ops.nms import nms_padded
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    cfg, predictor, batch = seeded_zoo_model(device, config_name)
    model = predictor.model
    pools = HEAD_POOLS[name]
    D = cfg.TEST.DETECTIONS_PER_IMAGE

    # (a) DefaultPredictor, one 480x640 image: first call (cuDNN's search) and steady
    img = np.random.RandomState(1).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    roi_align_multilevel_cuda.launches = 0
    request_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        n = len(inst)
        check(n > 0, "no detections")
        boxes = inst.pred_boxes.tensor
        check(torch.isfinite(boxes).all() and (boxes >= 0).all() and (boxes[:, 0::2] <= 640).all()
              and (boxes[:, 1::2] <= 480).all())
        if cfg.MODEL.MASK_ON:
            check_instances(inst, n, 480, 640)
        if cfg.MODEL.KEYPOINT_ON:
            check_keypoints(inst, n, 480, 640)
    predictor_launches = roi_align_multilevel_cuda.launches
    check(predictor_launches == 2 * len(pools), predictor_launches)
    log(f"  request 480x640: {n} instances, first {request_ms[0]:.1f} ms, steady {request_ms[1]:.1f} ms")

    # (b) batch forwards, 16 x 800x1344: the first records the pools
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_cuda.paths = {}
    nms_padded.rounds = 0
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, len(pools))
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    rounds = nms_padded.rounds
    times = []
    for _ in range(HEAD_FORWARDS):
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    batch_launches = roi_align_multilevel_cuda.launches
    paths = dict(roi_align_multilevel_cuda.paths)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(batch_launches == len(pools) * (1 + HEAD_FORWARDS), batch_launches)
    check(paths == {"vector": batch_launches}, paths)
    med = float(np.median(times))
    log(f"  batch forward {B}x{H}x{W}: median {med:.1f} ms/batch ({B / med * 1e3:.2f} img/s), "
        f"{min(times):.1f}-{max(times):.1f} ms over {HEAD_FORWARDS}; peak memory {peak:.2f} GiB; "
        f"NMS loop rounds in one forward {rounds}; B1 launches {batch_launches} {paths}")
    nms_ms = nms_timed_forward(model, batch)
    log("  NMS in one more forward, each call synchronised: " + ", ".join(
        f"{k} {v['ms']:.1f} ms in {v['calls']} calls, {v['rounds']} rounds" for k, v in nms_ms.items()))
    if "--profile" in sys.argv[1:]:
        profile_run(lambda: model(batch), f"{name} forward", None)

    check(out["pred_boxes"].shape == (B, D, 4) and torch.isfinite(out["pred_boxes"]).all())
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    if cfg.MODEL.MASK_ON:
        check(out["pred_masks"].shape[:2] == (B, D) and torch.isfinite(out["pred_masks"]).all())
    if cfg.MODEL.KEYPOINT_ON:
        kp = out["pred_keypoints"]
        check(kp.shape == (B, D, cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS, 4) and torch.isfinite(kp).all())
    log(f"  detections per image: {n_valid}")
    check(len(recorded) == len(pools), len(recorded))
    compared = compare_pools(recorded, pools, name)
    res = {
        "model": model,
        "cfg": cfg,
        "request_ms": request_ms,
        "batch_ms": med,
        "batch_ms_range": [min(times), max(times)],
        "img_s": B / med * 1e3,
        "peak_gib": peak,
        "nms_rounds": rounds,
        "nms_ms": nms_ms,
        "launches": predictor_launches + batch_launches,
        "pools": compared,
    }
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def phase_keypoint_eval(device, model, cfg, workdir: str, card: str):
    """``train_net --eval-only`` on the keypoint model: a synthetic person
    keypoint COCO (``write_synthetic_coco(keypoints=True)``) registered by
    name, DefaultTrainer.test with COCOEvaluator; bbox and keypoints AP
    finite, and AP 100 for the ground truth fed back."""
    import torch

    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.engine import DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import ground_truth_detections, write_synthetic_coco

    json_file, image_root = write_synthetic_coco(os.path.join(workdir, "kpt_coco"), KPT_EVAL_IMAGES, seed=1, keypoints=True)
    name = "chip_smoke_synthetic_person_keypoints"
    register_coco_instances(name, {}, json_file, image_root)
    cfg = cfg.clone()
    cfg.DATASETS.TEST = (name,)
    cfg.OUTPUT_DIR = ""
    evaluator = COCOEvaluator(name, distributed=False)
    timing = {}
    roi_align_multilevel_cuda.launches = 0
    t0 = time.perf_counter()
    results = DefaultTrainer.test(cfg, model, evaluators=[evaluator], timing=timing)
    test_s = time.perf_counter() - t0
    launches = roi_align_multilevel_cuda.launches
    batches = timing[name]["batches"]
    check(launches == 2 * batches, f"{launches} B1 launches over {batches} batches")
    check(set(results) == {"bbox", "keypoints"}, list(results))
    for task, keys in (("bbox", EVAL_KEYS), ("keypoints", KPT_EVAL_KEYS)):
        values = [results[task][k] for k in keys]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        log(f"  {task}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(keys, values)))
    contiguous = MetadataCatalog.get(name).thing_dataset_id_to_contiguous_id
    perfect = COCOEvaluator(name, distributed=False)
    by_image = {}
    for det in ground_truth_detections(json_file):
        det["category_id"] = contiguous[det["category_id"]]
        by_image.setdefault(det["image_id"], []).append(det)
    perfect._predictions = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    perfect_res = perfect.evaluate()
    for task in ("bbox", "keypoints"):
        check(perfect_res[task]["AP"] == 100.0, (task, perfect_res[task]))
    log(f"  {card}: {KPT_EVAL_IMAGES} person images, DefaultTrainer.test {test_s:.2f} s, B1 launches {launches} "
        f"(2 per batch); ground truth as detections: bbox AP {perfect_res['bbox']['AP']}, "
        f"keypoints AP {perfect_res['keypoints']['AP']}")
    return {
        "kpt_eval_s": test_s,
        "kpt_eval_bbox_AP": results["bbox"]["AP"],
        "kpt_eval_keypoints_AP": results["keypoints"]["AP"],
        "kpt_eval_launches": launches,
    }


def phase_tta(device, state_dict, coco, card: str):
    """GeneralizedRCNNWithTTA over the zoo R50-FPN 3x (phase 5's weights, bf16)
    on the first TTA_IMAGES images of phase 10's dataset with the config's
    TEST.AUG (9 sizes x flip); then one size (800) without the flip must
    equal DefaultPredictor on the same image."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.modeling.test_time_augmentation import GeneralizedRCNNWithTTA
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    cfg = model_zoo.get_config(EVAL_CONFIG)
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    json_file, image_root = coco
    with open(json_file) as f:
        images = json.load(f)["images"][:TTA_IMAGES]
    inputs = []
    for im in images:
        img = read_image(os.path.join(image_root, im["file_name"]), "BGR")
        inputs.append({"image": img, "height": img.shape[0], "width": img.shape[1]})
    aug = cfg.TEST.AUG
    copies = len(aug.MIN_SIZES) * (2 if aug.FLIP else 1)
    log(f"  TEST.AUG: MIN_SIZES {tuple(aug.MIN_SIZES)}, MAX_SIZE {aug.MAX_SIZE}, FLIP {aug.FLIP}: {copies} copies "
        f"an image; images {[(d['height'], d['width']) for d in inputs]}")
    tta = GeneralizedRCNNWithTTA(cfg, model)
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 2)
    try:
        t0 = time.perf_counter()
        outs = tta(inputs)
        torch.cuda.synchronize()
        tta_s = time.perf_counter() - t0
    finally:
        poolers.roi_align_multilevel = kernel_entry
    launches = roi_align_multilevel_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    # per image: every copy's box and mask pools, then the mask pool on the merged boxes
    check(launches == TTA_IMAGES * copies * 3, launches)
    for d, o in zip(inputs, outs):
        inst = o["instances"]
        check(0 < len(inst) <= cfg.TEST.DETECTIONS_PER_IMAGE, len(inst))
        check_instances(inst, len(inst), d["height"], d["width"])
    log(f"  {card}: TTA over {TTA_IMAGES} images in {tta_s:.2f} s ({tta_s / TTA_IMAGES:.2f} s an image), "
        f"B1 launches {launches}, peak memory {peak:.2f} GiB, {[len(o['instances']) for o in outs]} instances")
    compared = compare_pools(recorded, ("box", "mask"), "TTA first copy")

    # one size, no flip: TTA == DefaultPredictor on the same image
    single = cfg.clone()
    single.TEST.AUG.MIN_SIZES = (cfg.INPUT.MIN_SIZE_TEST,)
    single.TEST.AUG.MAX_SIZE = cfg.INPUT.MAX_SIZE_TEST
    single.TEST.AUG.FLIP = False
    predictor = DefaultPredictor(model=model, min_size_test=cfg.INPUT.MIN_SIZE_TEST, max_size_test=cfg.INPUT.MAX_SIZE_TEST,
                                 size_bucket=cfg.TPU.SIZE_BUCKET)
    agree = [
        instances_agree(GeneralizedRCNNWithTTA(single, model)([d])[0]["instances"], predictor(d["image"])["instances"])
        for d in inputs
    ]
    log(f"  single-scale TTA vs DefaultPredictor: {agree}")
    return {
        "tta_s_per_image": tta_s / TTA_IMAGES,
        "tta_peak_gib": peak,
        "launches": launches,
        "pools": compared,
        "phase_s": time.perf_counter() - t_phase,
    }


# ---------------------------------------------------------------- phases 18-22
# what the three heads' train steps pool, per image (ROI_HEADS.BATCH_SIZE_PER_IMAGE
# box slots and its positive fraction for the mask and keypoint pools), and
# the pools a step launches, in order
# 4 steps, not 20 (12 from phases 36-38, 5 from 39-40, 4 from 41-42): the
# whole run stays within 70% of its time limit (PERF.md section 4)
HEAD_TRAIN_ITERS = 4  # 5 until phases 41-42 came
HEAD_TRAIN_POOLS = {
    "keypoint": ("box", "keypoint"),
    "c4": ("res4",),
    "cascade": ("box stage 1", "box stage 2", "box stage 3", "mask"),
}
HEAD_TRAIN_CONFIGS = {"keypoint": KPT_CONFIG, "c4": C4_CONFIG, "cascade": CASCADE_CONFIG}
HEAD_TRAIN_IMAGES = 64
HEAD_TRAIN_PER_STEP = {
    "keypoint": "box pool + keypoint pool of the first 16-image train batch (Keypoint R-CNN)",
    "c4": "res4 pool (1024 channels) of the first 16-image train batch (C4)",
    "cascade": "3 stage box pools + mask pool of the first 16-image train batch (cascade)",
}
CASCADE_LOSSES = tuple(f"{k}_stage{s}" for s in range(3) for k in ("loss_cls", "loss_box_reg"))
HEAD_TRAIN_LOSSES = {
    "keypoint": ("loss_cls", "loss_box_reg", "loss_keypoint", "loss_rpn_cls", "loss_rpn_loc"),
    "c4": LOSSES,
    "cascade": CASCADE_LOSSES + ("loss_mask", "loss_rpn_cls", "loss_rpn_loc"),
}


def phase_train_shapes(device):
    """B1 and B2 against their plain versions at the shapes the three heads'
    train steps give them, 16 images a step: the C4 res4 pool (8192 rois,
    14x14, one level 16 x 50x84 x 1024), the keypoint pool (2048 rois, 14x14
    over p2-p5, C 256), a cascade box pool (8192 rois, 7x7 over p2-p5) and
    the mask pool (2048 rois, 14x14); float32 and bfloat16, both grids,
    sampling ratio 0 and 2; every case on the 16-byte path, the backward
    bitwise equal over two launches; bf16 aligned s = 0 timed beside the
    bounds."""
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    fpn_shapes = [(B, H // s, W // s, C) for s in STRIDES]
    res4_shape = [(B, H // C4_STRIDE, W // C4_STRIDE, C4_C)]
    cases = (
        ("c4 res4", res4_shape, TRAIN_BOX_ROIS, MASK_RES),
        ("keypoint", fpn_shapes, TRAIN_MASK_ROIS, MASK_RES),
        ("cascade box", fpn_shapes, TRAIN_BOX_ROIS, BOX_RES),
        ("mask", fpn_shapes, TRAIN_MASK_ROIS, MASK_RES),
    )
    results = {}
    for name, shapes, n, res in cases:
        boxes, bidx = synthetic_rois(gen, n, device, batch=B)
        if len(shapes) == 1:
            scales, levels = (1.0 / C4_STRIDE,), torch.zeros(boxes.shape[0], dtype=torch.int32, device=device)
        else:
            scales, levels = tuple(1.0 / s for s in STRIDES), assign_boxes_to_levels(boxes, 2, 5)
        feats32 = [torch.randn(sh, generator=gen, device=device) for sh in shapes]
        g32 = torch.randn((boxes.shape[0], res, res, shapes[0][-1]), generator=gen, device=device)
        log(f"  {name}: {boxes.shape[0]} rois at {res}x{res} over {shapes}")
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in feats32]
            g = g32.to(dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            for aligned in (True, False):
                for sr in (0, 2):
                    timing = dtype == torch.bfloat16 and aligned and sr == 0
                    label = f"{name} R={boxes.shape[0]} {res}x{res} {tag} aligned={aligned} sr={sr}"
                    with torch.inference_mode():
                        f = compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, label, timing, vector=True)
                    b = compare_backward(g, shapes, boxes, bidx, levels, scales, res, sr, aligned, "bwd " + label, timing)
                    check(b["path"] == "vector", f"{label}: the backward took the {b['path']} path")
                    if timing:
                        results[name] = {"fwd": f, "bwd": b, "res": res}
            del feats, g
        del feats32, g32
        torch.cuda.empty_cache()
    return results


def heads_train_setup(name: str, workdir: str, coco):
    """The registered train and test sets (the first TRAINER_TEST_IMAGES
    images) of a head family's train phase: phase 10's COCO images for C4
    and cascade, person keypoint images with COCO's keypoint names and flip
    map for the keypoint model."""
    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_PERSON_KEYPOINT_FLIP_MAP, COCO_PERSON_KEYPOINT_NAMES
    from detectron2_tpu_torch.testing import write_synthetic_coco

    t0 = time.perf_counter()
    if name == "keypoint":
        coco = write_synthetic_coco(os.path.join(workdir, "kpt_train"), HEAD_TRAIN_IMAGES, seed=2, keypoints=True)
    json_file, image_root = coco
    train_name, test_name = f"chip_smoke_{name}_train", f"chip_smoke_{name}_test{TRAINER_TEST_IMAGES}"
    test_json = first_images(json_file, TRAINER_TEST_IMAGES, os.path.join(workdir, f"{name}_test.json"))
    for dataset, json_path in ((train_name, json_file), (test_name, test_json)):
        register_coco_instances(dataset, {}, json_path, image_root)
        if name == "keypoint":
            MetadataCatalog.get(dataset).set(keypoint_names=COCO_PERSON_KEYPOINT_NAMES, keypoint_flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP)
    return train_name, test_name, time.perf_counter() - t0


def phase_heads_train(device, card: str, workdir: str, name: str, coco):
    """``tools/train_net.py`` training of a head family's zoo yaml on the
    port at its full width and training input (16 images a step, 640-800
    / 1333, flips): seeded weights with FrozenBN calibrated on 4 train
    images, HEAD_TRAIN_ITERS DefaultTrainer steps (warmup over 100,
    gradients clipped to a global norm of 1) and one EvalHook evaluation.
    Checks: finite losses at every step, B1 and B2 launched once per pool a
    step, every trainable parameter of the keypoint or mask head moved,
    both kernels held to their plain versions on the first batch's pools
    and cotangents, every printed AP finite and in [0, 100]."""
    import torch

    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.engine import DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    pools, losses_keys = HEAD_TRAIN_POOLS[name], HEAD_TRAIN_LOSSES[name]
    train_name, test_name, write_s = heads_train_setup(name, workdir, coco)
    cfg = zoo_train_config(HEAD_TRAIN_CONFIGS[name], train_name, test_name, os.path.join(workdir, f"{name}_trainer"),
                           HEAD_TRAIN_ITERS)
    if name == "keypoint":
        check(cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN == 1500, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN)
    cfg.MODEL.WEIGHTS = ""  # seeded weights, calibrated below
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * HEAD_TRAIN_ITERS  # the final checkpoint only

    class SmokeTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, distributed=False, kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS)

        def build_writers(self):
            return []

    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    t0 = time.perf_counter()
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    calib = next(iter(build_detection_test_loader(cfg, train_name, batch_size=4)))
    calibrate_frozen_bn(trainer.model, {k: v for k, v in calib.items() if k != "metadata"})
    build_s = time.perf_counter() - t0
    check(trainer.model.device.type == device.type, trainer.model.device)
    head_prefix = {"keypoint": "roi_heads.keypoint_head.", "c4": "roi_heads.mask_head.", "cascade": "roi_heads.mask_head."}[name]
    head0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith(head_prefix)}
    check(head0 and all(p.requires_grad for k, p in trainer.model.named_parameters() if k in head0), head_prefix)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"  {HEAD_TRAIN_CONFIGS[name]} bf16, {cfg.SOLVER.IMS_PER_BATCH} images a step, MIN_SIZE_TRAIN "
        f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)}, MAX_SIZE_TRAIN {cfg.INPUT.MAX_SIZE_TRAIN}, flip {cfg.INPUT.RANDOM_FLIP}, "
        f"POST_NMS_TOPK_TRAIN {cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN}, ROI_HEADS {cfg.MODEL.ROI_HEADS.NAME}; {n_params} "
        f"parameters, seeded, FrozenBN calibrated on 4 train images; data written in {write_s:.2f} s, built in {build_s:.2f} s")
    recorded = []
    n_pools = len(pools)
    results, steps, train_s, peak = train_counted(trainer, recorded, n_pools)
    fwd_launches, bwd_launches, paths = fwd_k.launches, bwd_k.launches, dict(fwd_k.paths)

    check(len(steps) == HEAD_TRAIN_ITERS, len(steps))
    check(all(s == (n_pools, n_pools) for s in steps), f"per-step (forward, backward) launches {steps}")
    eval_launches = fwd_launches - sum(f for f, _ in steps)
    eval_pools = len(HEAD_POOLS[name])  # an eval batch pools as phases 14-16's forwards do
    check(eval_launches == eval_pools * TRAINER_TEST_IMAGES, f"{eval_launches} forward launches over {TRAINER_TEST_IMAGES} eval batches")
    check(bwd_launches == n_pools * HEAD_TRAIN_ITERS, f"backward launches {bwd_launches}")
    check(paths == {"vector": fwd_launches}, paths)
    storage = trainer.storage
    for k in losses_keys:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == HEAD_TRAIN_ITERS and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))
    unmoved = [k for k, p in trainer.model.named_parameters() if k in head0 and torch.equal(p.detach(), head0[k])]
    check(not unmoved, f"{head_prefix} parameters that did not move: {unmoved}")
    log(f"  every one of the {len(head0)} trainable tensors of {head_prefix[:-1]} moved")
    tasks = ("bbox", "keypoints") if name == "keypoint" else ("bbox", "segm")
    check(set(results) == set(tasks), list(results))
    aps = {}
    for task in tasks:
        keys = KPT_EVAL_KEYS if task == "keypoints" else EVAL_KEYS
        values = [results[task][k] for k in keys]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        aps[task] = results[task]["AP"]
        log(f"  EvalHook {task}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(keys, values)))
    log(f"  {HEAD_TRAIN_ITERS} steps + evaluation in {train_s:.2f} s; B1 launches {fwd_launches} ({n_pools * HEAD_TRAIN_ITERS} "
        f"in steps, {eval_launches} in {TRAINER_TEST_IMAGES} eval batches), B2 launches {bwd_launches}")

    stats = step_times(storage, cfg.SOLVER.IMS_PER_BATCH, card, peak)

    fwd, bwd = compare_recorded_pools(recorded, f"{name} first-batch", keys=pools)
    if "--profile" in sys.argv[1:]:
        model, optimizer = trainer.model, trainer.optimizer
        batch = next(trainer._trainer._data_loader_iter)

        def one_step():
            losses = model(batch, train=True, generator=trainer._trainer.generator)
            optimizer.zero_grad(set_to_none=True)
            sum(losses.values()).backward()
            optimizer.step()

        profile_run(one_step, f"{name} train step", None)
    del trainer
    phase_s = time.perf_counter() - t_phase
    return {
        **{f"{name}_train_{k}": v for k, v in stats.items()},
        f"{name}_train_peak_gib": peak,
        f"{name}_train_phase_s": phase_s,
        **{f"{name}_train_{task}_AP": ap for task, ap in aps.items()},
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }


VITDET_TRAIN_CONFIG = "ViTDet/mask_rcnn_vitdet_b_100ep.py"
# 4 steps and a checkpoint at 2, not 20 and 10
VITDET_TRAIN_ITERS, VITDET_TRAIN_CKPT, VITDET_TRAIN_BATCH = 4, 2, 8  # 6 and 3 until phases 41-42 came
VITDET_TRAIN_LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")
VITDET_TRAIN_TIMED_STEPS = 3  # a fixed batch's train step, timed with CUDA events after the run


def lazy_train_args(tool, config: str, out_name: str, batch: int, ckpt: int, workdir: str, coco, train_name: str,
                    test_name: str, iters: int, resume: bool = False, extra=(), test_images: int = TRAINER_TEST_IMAGES):
    """The command line of a ``lazyconfig_train_net`` run of the repo's
    ``config`` as it is, with the smoke run's cuts (PERF.md section 4) as
    overrides: ``batch`` images a step, ``iters`` steps, a checkpoint every
    ``ckpt``, the evaluation on ``test_images`` images after training, seed
    0, and ``extra``."""
    json_file, image_root = coco
    test_json = first_images(json_file, test_images, os.path.join(workdir, f"{out_name}_test{test_images}.json"))
    opts = [
        f"dataloader.train.dataset.names={train_name}",
        f"dataloader.test.dataset.names={test_name}",
        f"dataloader.evaluator.dataset_name={test_name}",
        f"dataloader.train.total_batch_size={batch}",
        f"train.max_iter={iters}",
        f"train.checkpointer.period={ckpt}",
        "train.eval_period=0",
        "train.seed=0",
        "train.log_period=1",
        f"train.output_dir={os.path.join(workdir, out_name)}",
        *extra,
    ]
    argv = ["--config-file", os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", config)]
    argv += ["--resume"] if resume else ["--dataset", train_name, json_file, image_root, "--dataset", test_name, test_json, image_root]
    return tool.argument_parser().parse_args(argv + opts)


def vitdet_train_args(tool, workdir: str, coco, train_name: str, test_name: str, iters: int, resume: bool = False):
    """Phase 23's command line: the zoo ViTDet-B config, 8 images a step;
    20 steps from seeded weights leave no score over 0.05, so the
    evaluation runs at threshold 0."""
    return lazy_train_args(tool, VITDET_TRAIN_CONFIG, "vitdet_train", VITDET_TRAIN_BATCH, VITDET_TRAIN_CKPT, workdir, coco,
                           train_name, test_name, iters, resume, ["model.roi_heads.box_predictor.test_score_thresh=0.0"])


def recording_attention(attn_entry, attn_rec, recording):
    """A stand-in for ``vit.attention_with_rel_pos`` that keeps a copy of the
    inputs of the first global and the first windowed block called while
    ``recording()`` is true."""

    def rec_attn(q, k, v, rel_h, rel_w, *, scale, factors_transposed):
        name = "global" if q.shape[1] == ATTN_SHAPES["global"][1] else "windowed"
        if recording() and name not in attn_rec:
            attn_rec[name] = ([t.detach().clone() for t in (q, k, v, rel_h, rel_w)], scale)
        return attn_entry(q, k, v, rel_h, rel_w, scale=scale, factors_transposed=factors_transposed)

    return rec_attn


def compare_recorded_attention(attn_rec, label: str, device):
    """B3 against its plain version on a train step's recorded global and
    windowed blocks (timed), and the kernel-forward attention's gradient
    against the plain function's autograd there."""
    import torch

    from detectron2_tpu_torch.ops import attention as A

    attn = {}
    for name in ATTN_SHAPES:
        check(name in attn_rec, f"no {name} block recorded")
        args_, scale = attn_rec[name]
        check(tuple(args_[0].shape) == ATTN_SHAPES[name][:3] and args_[0].dtype == torch.bfloat16, (name, args_[0].shape))
        with torch.no_grad():
            attn[name] = compare_attention(args_, scale, False, ATTN_CHUNK[name], f"{label} {name} block", timing=True)
        check(attn[name]["path"] == ATTN_MAIN_PATHS[name], attn[name]["path"])
        ins = [t.detach().requires_grad_(True) for t in args_]
        out = A.attention_with_rel_pos(*ins, scale=scale)
        g = torch.randn(out.shape, generator=torch.Generator(device=device).manual_seed(1), device=device).to(out.dtype)
        grads = torch.autograd.grad(out, ins, g)
        ref_ins = [t.detach().requires_grad_(True) for t in args_]
        ref = plain_in_chunks(A.attention_plain, ref_ins, scale, ATTN_CHUNK[name])
        ref_grads = torch.autograd.grad(ref, ref_ins, g)
        gerr = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads))
        gmax = max(b.float().abs().max().item() for b in ref_grads)
        check(gerr <= 2.0**-7 * gmax, f"{name}: the gradient differs from the plain autograd by {gerr} (max {gmax})")
        attn[name]["grad_max_abs_err"] = gerr
        log(f"  {name}: gradient of the kernel-forward attention vs the plain function's autograd: max_abs_err {gerr:.3e} "
            f"(|grad| max {gmax:.3e})")
        del ins, out, grads, ref_ins, ref, ref_grads
    attn_rec.clear()
    return attn


def phase_vitdet_train(device, card: str, workdir: str, coco):
    """ViTDet-B training through the port's ``lazyconfig_train_net`` from
    the repo's ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py`` as it is (LSJ
    onto 1024x1024 with flips and boxes recomputed from the cropped masks,
    RGB, DropPath 0.1, the layer-wise AdamW and the config's LR schedule,
    bf16), on phase 10's synthetic PNGs registered by flag, with the cuts
    of ``vitdet_train_args``. Checks: finite losses every step, parameters
    moved in the ViT blocks, the SimpleFeaturePyramid and the heads,
    DropPath dropped, B3 launched 12 times a step (4 ``wgmma`` + 8
    ``mma_window``) and B1/B2 twice on the 16-byte path; B1/B2 held to
    their plain versions on the first batch's pools, B3 on a global and a
    windowed block's recorded q/k/v, and the kernel-forward attention's
    gradient to the plain function's autograd there; a resume from the
    step-6 checkpoint. Measures: step ms, the loader's share, peak memory,
    and the attention backward's device time in a step and its share."""
    import torch

    import detectron2_tpu_torch.modeling.backbone.vit as vit
    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.config import LazyConfig
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.layers import DropPath
    from detectron2_tpu_torch.ops import attention as A
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    t_phase = time.perf_counter()
    train_name, test_name = "chip_smoke_vitdet_train", "chip_smoke_vitdet_test16"
    args = vitdet_train_args(tool, workdir, coco, train_name, test_name, VITDET_TRAIN_ITERS)

    # the config as the zoo has it, before the run's overrides
    zoo = LazyConfig.load(args.config_file)
    net, aug = zoo.model.backbone.net, zoo.dataloader.train.mapper.augmentations
    check((net.embed_dim, net.depth, net.num_heads, net.img_size, net.drop_path_rate, net.window_size,
           tuple(net.window_block_indexes)) == (768, 12, 12, 1024, 0.1, 14, (0, 1, 3, 4, 6, 7, 9, 10)), net)
    check([a._target_.rsplit(".", 1)[1] for a in aug] == ["RandomFlip", "ResizeScale", "FixedSizeCrop"], aug)
    check((aug[1].min_scale, aug[1].max_scale, aug[1].target_height, tuple(aug[2].crop_size)) == (0.1, 2.0, 1024, (1024, 1024)), aug)
    mapper = zoo.dataloader.train.mapper
    check((mapper.recompute_boxes, mapper.use_instance_mask, mapper.image_format) == (True, True, "RGB"), mapper)
    check(zoo.optimizer._target_.__name__ == "make_optimizer" and zoo.dataloader.train.total_batch_size == 64, zoo.optimizer)
    sched = zoo.lr_multiplier.multiplier
    check((sched.warmup_factor, round(sched.warmup_length * 184375, 6), zoo.lr_multiplier.base_lr) == (0.001, 250, 1e-4), sched)

    fwd_k, bwd_k, attn_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda, A.flash_attention_cuda
    per_step, attn_bwd_ms, step_paths = [], [], {}
    bwd_events = []
    drops = {"calls": 0, "dropped": torch.zeros((), dtype=torch.int64, device=device), "samples": 0}
    snapshot = {}

    def groups(model):
        """ViT blocks, SimpleFeaturePyramid, heads (RPN + ROI heads)."""
        out = {"vit_blocks": {}, "sfp": {}, "heads": {}}
        for k, p in model.named_parameters():
            if k.startswith("backbone.net.blocks."):
                out["vit_blocks"][k] = p
            elif k.startswith("backbone.simfp_"):
                out["sfp"][k] = p
            elif k.startswith(("proposal_generator.", "roi_heads.")):
                out["heads"][k] = p
        return out

    def before_train(trainer):
        for g, ps in groups(trainer.model).items():
            snapshot[g] = {k: p.detach().clone() for k, p in ps.items()}

    def after_step(trainer):
        per_step.append((fwd_k.launches, bwd_k.launches, attn_k.launches))
        torch.cuda.synchronize()
        attn_bwd_ms.append(sum(a.elapsed_time(b) for a, b in bwd_events))
        bwd_events.clear()
        if trainer.iter == VITDET_TRAIN_ITERS - 1:
            step_paths.update(attn_k.paths)

    # the attention backward, timed with CUDA events around every call
    backward = A._Attention.backward

    def timed_backward(ctx, grad):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = backward(ctx, grad)
        b.record()
        bwd_events.append((a, b))
        return out

    # DropPath: the samples it zeroed in training (counted on the device)
    drop_forward = DropPath.forward

    def counting_drop(self, x, train=False, generator=None):
        y = drop_forward(self, x, train, generator)
        if train and self.rate > 0:
            drops["calls"] += 1
            drops["samples"] += x.shape[0]
            drops["dropped"] += (y.detach().reshape(y.shape[0], -1) == 0).all(dim=1).sum()
        return y

    # the first step's attention inputs: one global and one windowed block
    attn_rec = {}
    attn_entry = vit.attention_with_rel_pos
    rec_attn = recording_attention(attn_entry, attn_rec, lambda: not per_step)

    recorded = []
    pool_entry = poolers.roi_align_multilevel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_k.launches = bwd_k.launches = attn_k.launches = 0
    fwd_k.paths, attn_k.paths = {}, {}
    A._Attention.backward = staticmethod(timed_backward)
    DropPath.forward = counting_drop
    vit.attention_with_rel_pos = rec_attn
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    t0 = time.perf_counter()
    try:
        trainer = tool.main(args, extra_hooks=[hooks.CallbackHook(before_train=before_train, after_step=after_step)])
    finally:
        A._Attention.backward = staticmethod(backward)
        DropPath.forward = drop_forward
        vit.attention_with_rel_pos = attn_entry
        poolers.roi_align_multilevel = pool_entry
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_launches, bwd_launches, attn_launches = fwd_k.launches, bwd_k.launches, attn_k.launches
    model, storage = trainer.model, trainer.storage
    check(model.device.type == device.type and model.compute_dtype == torch.bfloat16, (model.device, model.compute_dtype))
    check(type(trainer.optimizer).__name__ == "AdamWGroupClip" and len(trainer.optimizer.param_groups) == 14,
          [g["lr_factor"] for g in trainer.optimizer.param_groups])

    # launches: per step B1 and B2 twice, B3 once per block; then the evaluation
    check(len(per_step) == VITDET_TRAIN_ITERS, len(per_step))
    steps = [tuple(c - p for c, p in zip(cur, prev)) for cur, prev in zip(per_step, [(0, 0, 0)] + per_step[:-1])]
    blocks = sum(ATTN_PER_FORWARD.values())
    check(all(s == (2, 2, blocks) for s in steps), f"per-step (B1, B2, B3) launches {steps}")
    check(step_paths == {ATTN_MAIN_PATHS[n]: ATTN_PER_FORWARD[n] * VITDET_TRAIN_ITERS for n in ATTN_SHAPES}, step_paths)
    check(set(fwd_k.paths) == {"vector"}, fwd_k.paths)
    eval_fwd, eval_attn = fwd_launches - per_step[-1][0], attn_launches - per_step[-1][2]
    check(eval_fwd == 2 * TRAINER_TEST_IMAGES and eval_attn == blocks * TRAINER_TEST_IMAGES,
          f"{eval_fwd} B1 and {eval_attn} B3 launches over {TRAINER_TEST_IMAGES} eval images")
    check(bwd_launches == 2 * VITDET_TRAIN_ITERS, bwd_launches)
    for k in VITDET_TRAIN_LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == VITDET_TRAIN_ITERS and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))
    lrs = [v for v, _ in storage.history("lr").values()]
    check(0 < lrs[-1] <= 0.08 * 1e-4 * 1.0001, lrs)
    log(f"  lr of the top group (factor 1) over the steps: {lrs[0]:.4e} -> {lrs[-1]:.4e} (warmup over 250 steps)")
    moved = {}
    for g, ps in groups(model).items():
        changed = [k for k, p in ps.items() if not torch.equal(p.detach(), snapshot[g][k])]
        moved[g] = (len(changed), len(ps))
        unmoved = sorted(set(ps) - set(changed))
        check(ps and len(changed) >= 0.9 * len(ps), f"{g}: {len(changed)} of {len(ps)} moved; unmoved {unmoved[:8]}")
        log(f"  {g}: {len(changed)} of {len(ps)} parameter tensors moved" + (f" (unmoved: {unmoved})" if unmoved else ""))
    dropped = int(drops["dropped"].item())
    check(drops["calls"] == 24 * VITDET_TRAIN_ITERS - 2 * VITDET_TRAIN_ITERS and dropped > 0, drops)
    log(f"  DropPath: {drops['calls']} training calls (blocks 1-11, rate 0.1 * i / 11), {dropped} of {drops['samples']} "
        f"samples dropped ({dropped / drops['samples']:.2%}; expected {np.mean([0.1 * i / 11 for i in range(1, 12)]):.2%})")
    aps = {}
    for task in ("bbox", "segm"):
        values = [storage.latest()[f"{task}/{k}"][0] for k in ("AP", "AP50", "AP75")]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        aps[task] = values[0]
    log(f"  {VITDET_TRAIN_ITERS} steps + do_test over {TRAINER_TEST_IMAGES} images in {train_s:.2f} s; EvalHook bbox AP "
        f"{aps['bbox']:.4f}, segm AP {aps['segm']:.4f}; launches B1 {fwd_launches} ({eval_fwd} in eval), B2 {bwd_launches}, "
        f"B3 {attn_launches} ({eval_attn} in eval; steps {step_paths})")
    stats = step_times(storage, VITDET_TRAIN_BATCH, card, peak)
    bwd_ms = float(np.median(attn_bwd_ms[3:]))
    compute_ms = stats["ms_per_step"] - stats["data_ms_per_step"]
    log(f"  attention backward (recompute + autograd of the plain version, 12 calls a step): median {bwd_ms:.2f} ms a step, "
        f"{bwd_ms / stats['ms_per_step']:.1%} of the median step, {bwd_ms / compute_ms:.1%} of its time outside the loader")

    # one fixed batch's train step, timed alone (no loader): the backward's share of it
    batch = next(trainer._data_loader_iter)
    optimizer, gen = trainer.optimizer, trainer.generator

    def one_step():
        losses = model(batch, train=True, generator=gen)
        optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        optimizer.step()

    A._Attention.backward = staticmethod(timed_backward)
    try:
        bwd_events.clear()
        one_step()
        torch.cuda.synchronize()
        bwd_events.clear()
        step_ms = event_ms(one_step, 0, VITDET_TRAIN_TIMED_STEPS)
        torch.cuda.synchronize()
        fixed_bwd_ms = sum(a.elapsed_time(b) for a, b in bwd_events) / VITDET_TRAIN_TIMED_STEPS
    finally:
        A._Attention.backward = staticmethod(backward)
    bwd_share = fixed_bwd_ms / step_ms
    log(f"  one fixed batch's train step: {step_ms:.2f} ms (CUDA events, {VITDET_TRAIN_TIMED_STEPS} steps), of it the "
        f"attention backward {fixed_bwd_ms:.2f} ms ({bwd_share:.1%})")
    if "--profile" in sys.argv[1:]:
        profile_run(one_step, "ViTDet-B train step", "vitdet_train_step_trace.json")

    # the kernels on the run's own inputs
    fwd, bwd = compare_recorded_pools(recorded, "ViTDet train first-batch")
    attn = compare_recorded_attention(attn_rec, "ViTDet train", device)

    # resume from the checkpoint at VITDET_TRAIN_CKPT: that iteration, equal state, one step
    out_dir = os.path.join(workdir, "vitdet_train")
    ckpt = os.path.join(out_dir, f"model_{VITDET_TRAIN_CKPT - 1:07d}.pth")
    for name in (f"model_{VITDET_TRAIN_CKPT - 1:07d}.pth", f"model_{VITDET_TRAIN_ITERS - 1:07d}.pth", "model_final.pth"):
        check(os.path.exists(os.path.join(out_dir, name)), name)
    with open(os.path.join(out_dir, "last_checkpoint"), "w") as f:
        f.write(os.path.basename(ckpt))
    del trainer, model, optimizer, batch
    torch.cuda.empty_cache()
    args2 = vitdet_train_args(tool, workdir, coco, train_name, test_name, VITDET_TRAIN_CKPT + 1, resume=True)
    cfg2 = LazyConfig.apply_overrides(LazyConfig.load(args2.config_file), args2.opts)
    del cfg2.dataloader["evaluator"]
    second, start = tool.build_trainer(args2, cfg2)
    check(start == VITDET_TRAIN_CKPT, start)
    saved = torch.load(ckpt, map_location=device, weights_only=False)
    state = second.model.state_dict()
    check(state.keys() == saved["model"].keys() and all(torch.equal(state[k], v) for k, v in saved["model"].items()),
          "the resumed model differs from the checkpoint")
    opt, ref_opt = second.optimizer.state_dict(), saved["trainer"]["optimizer"]
    check(opt["state"].keys() == ref_opt["state"].keys() and all(
        torch.equal(opt["state"][j]["exp_avg_sq"], ref_opt["state"][j]["exp_avg_sq"]) for j in ref_opt["state"]),
        "the resumed AdamW state differs from the checkpoint")
    fwd_k.launches = bwd_k.launches = attn_k.launches = 0
    second.train(start, VITDET_TRAIN_CKPT + 1)
    torch.cuda.synchronize()
    check((fwd_k.launches, bwd_k.launches, attn_k.launches) == (2, 2, blocks), (fwd_k.launches, bwd_k.launches, attn_k.launches))
    check([i for _, i in second.storage.history("total_loss").values()] == [VITDET_TRAIN_CKPT], "the resumed step")
    resumed_loss = second.storage.history("total_loss").latest()
    check(math.isfinite(resumed_loss), resumed_loss)
    log(f"  resumed at iteration {start} from {os.path.basename(ckpt)}: model ({len(state)} tensors) and AdamW state bitwise "
        f"equal to the checkpoint; one step, total_loss {resumed_loss:.4f}")
    del second
    phase_s = time.perf_counter() - t_phase
    return {
        **{f"vitdet_train_{k}": v for k, v in stats.items()},
        "vitdet_train_peak_gib": peak,
        "vitdet_train_phase_s": phase_s,
        "vitdet_train_attn_bwd_ms": bwd_ms,
        "vitdet_train_fixed_step_ms": step_ms,
        "vitdet_train_fixed_attn_bwd_ms": fixed_bwd_ms,
        "vitdet_train_attn_bwd_share": bwd_share,
        "vitdet_train_bbox_AP": aps["bbox"],
        "vitdet_train_segm_AP": aps["segm"],
        "vitdet_train_moved": moved,
        "vitdet_train_dropped": dropped,
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "attn_launches": attn_launches,
        "attn_paths": step_paths,
        "fwd": fwd,
        "bwd": bwd,
        "attn": attn,
    }


LSJ_TRAIN_CONFIG = "new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py"
# 4 steps, not 20 (12 until phases 34-35 came, 8 until 36-38): the whole run
# stays within 70% of its time limit (PERF.md section 4)
LSJ_TRAIN_ITERS, LSJ_TRAIN_CKPT = 4, 2
# 16 images a step (the recipe's 64 over 8 cards; 32, the most that fits the
# H100's 80 GB, until phases 43-44 came: PERF.md section 4)
LSJ_TRAIN_BATCH = 16
LSJ_BN_COUNT = 53 + 8 + 8  # ResNet-50, FPN (4 lateral + 4 output convs), 4conv box head + 4-conv mask head
PRECISE_BN_CONFIG = "Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml"
PRECISE_BN_ITERS, PRECISE_BN_NUM_ITER = 4, 4  # 6 steps until phases 39-40 came


def lsj_train_args(tool, workdir: str, coco, train_name: str, test_name: str, iters: int, resume: bool = False):
    """Phase 24's command line: the ``new_baselines`` R50-FPN LSJ recipe,
    ``LSJ_TRAIN_BATCH`` images a step."""
    return lazy_train_args(tool, LSJ_TRAIN_CONFIG, "lsj_train", LSJ_TRAIN_BATCH, LSJ_TRAIN_CKPT, workdir, coco, train_name,
                           test_name, iters, resume)


def bn_conv_profile(one_step, label: str) -> dict:
    """One call of ``one_step`` under torch.profiler: the device time of the
    BN passes (every ``BatchNorm2d.forward`` in a ``record_function`` range,
    every ``_BatchNormTrainBackward``), of the RPN's NMS (each
    ``proposal_utils.nms_padded`` call in a range), of the convolutions
    (``aten::convolution`` and ``aten::convolution_backward``) and of the
    matmuls (``aten::mm``, ``aten::addmm``, ``aten::bmm``), each the device
    time of the kernels launched inside those operators, against the step's
    busy time (every kernel); the top kernels by device time are logged.
    Every ms is "not measured" when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import detectron2_tpu_torch.modeling.proposal_generator.proposal_utils as proposal_utils
    from detectron2_tpu_torch.layers import BatchNorm2d

    forward, nms = BatchNorm2d.forward, proposal_utils.nms_padded

    def ranged_bn(self, x, train):
        with record_function("d2t::batch_norm_forward"):
            return forward(self, x, train)

    def ranged_nms(*args, **kwargs):
        with record_function("d2t::rpn_nms"):
            return nms(*args, **kwargs)

    BatchNorm2d.forward, proposal_utils.nms_padded = ranged_bn, ranged_nms
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        BatchNorm2d.forward, proposal_utils.nms_padded = forward, nms
    names = {"d2t::batch_norm_forward": "bn_fwd", "_BatchNormTrainBackward": "bn_bwd", "d2t::rpn_nms": "nms",
             "aten::convolution": "conv_fwd", "aten::convolution_backward": "conv_bwd",
             "aten::mm": "matmul", "aten::addmm": "matmul", "aten::bmm": "matmul"}
    sums = dict.fromkeys([*dict.fromkeys(names.values()), "busy"], 0.0)
    counts = dict.fromkeys(names.values(), 0)
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("d2t::"):  # kernels, not the ranges' own spans
            ms = e.device_time_total / 1e3
            sums["busy"] += ms
            total, k = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (total + ms, k + 1)
        elif e.device_type == DeviceType.CPU and e.name in names:
            sums[names[e.name]] += e.device_time_total / 1e3
            counts[names[e.name]] += 1
    if sums["busy"] == 0:
        log(f"  profiled {label}: the profiler saw no device time; BN, NMS, convolution and matmul device times not measured")
        return {k: "not measured" for k in ("bn_fwd", "bn_bwd", "nms", "conv", "matmul", "busy")}
    busy = sums["busy"]
    bn, conv = sums["bn_fwd"] + sums["bn_bwd"], sums["conv_fwd"] + sums["conv_bwd"]
    log(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms; BN passes {bn:.1f} ms "
        f"({sums['bn_fwd']:.1f} forward in {counts['bn_fwd']} calls + {sums['bn_bwd']:.1f} backward in "
        f"{counts['bn_bwd']}), {bn / busy:.1%}; convolutions {conv:.1f} ms ({sums['conv_fwd']:.1f} forward in "
        f"{counts['conv_fwd']} + {sums['conv_bwd']:.1f} backward in {counts['conv_bwd']}), {conv / busy:.1%}; matmuls "
        f"{sums['matmul']:.1f} ms in {counts['matmul']} calls, {sums['matmul'] / busy:.1%}; the RPN's NMS "
        f"{sums['nms']:.1f} ms in {counts['nms']} calls, {sums['nms'] / busy:.1%}")
    for name, (ms, k) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:9.3f} ms  {k:6d}x  {name[:110]}")
    out = {"bn_fwd": sums["bn_fwd"], "bn_bwd": sums["bn_bwd"], "nms": sums["nms"], "conv": conv,
           "matmul": sums["matmul"], "busy": busy, "wall": wall_ms}
    out.update({f"{k}_share": out[k] / busy for k in ("nms", "conv", "matmul")}, bn_share=bn / busy)
    return out


def phase_lsj_train(device, card: str, workdir: str, coco):
    """Mask R-CNN R50-FPN trained from scratch through the port's
    ``lazyconfig_train_net`` from the repo's
    ``configs/new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py`` as it is
    (SyncBN in every conv of the ResNet, the FPN, the 4conv1fc box head and
    the 4-conv mask head; FREEZE_AT 0; a 2-conv RPN head; LSJ 0.1-2.0 onto
    1024x1024 with flips and boxes recomputed; SGD with the recipe's groups,
    LR 0.1 and weight decay 4e-5 under its warmup + multistep schedule;
    bf16), on phase 10's synthetic PNGs registered by flag, with the cuts of
    ``lsj_train_args``. Checks: finite losses every step; every BN left the
    batch-statistics path with its running statistics moved from 0 / 1;
    parameters moved in the stem, res5, the FPN and both heads; B1 and B2
    launched twice a step and held to their plain versions on the first
    batch's pools and cotangents; a resume from the mid-run checkpoint with
    the parameters, the momentum buffers and every running statistic equal
    to the checkpoint's right after the load; one evaluation with the
    running statistics over 8 images, finite AP. Measures: step ms, the
    loader's share, peak memory, the BN passes' device time in one profiled
    step against the RPN's NMS and the cuDNN/cuBLAS kernels'."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.config import LazyConfig
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.layers import SyncBatchNorm, get_bn_modules
    from detectron2_tpu_torch.ops.nms import nms_padded
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    t_phase = time.perf_counter()
    train_name, test_name = "chip_smoke_lsj_train", "chip_smoke_lsj_test16"
    args = lsj_train_args(tool, workdir, coco, train_name, test_name, LSJ_TRAIN_ITERS)

    # the recipe as the repo has it, before the run's overrides
    zoo = LazyConfig.load(args.config_file)
    aug = zoo.dataloader.train.mapper.augmentations
    check(zoo.model._target_.__name__ == "build_lsj_model" and not zoo.model.keys() - {"_target_"}, zoo.model)
    check([a._target_.rsplit(".", 1)[1] for a in aug] == ["ResizeScale", "FixedSizeCrop", "RandomFlip"], aug)
    check((aug[0].min_scale, aug[0].max_scale, aug[0].target_height, tuple(aug[1].crop_size)) == (0.1, 2.0, 1024, (1024, 1024)), aug)
    check(zoo.dataloader.train.mapper.recompute_boxes and zoo.dataloader.train.total_batch_size == 64, zoo.dataloader.train)
    check((zoo.train.init_checkpoint, zoo.optimizer.lr_schedule, zoo.optimizer.weight_decay, zoo.optimizer.weight_decay_norm)
          == ("", 0.1, 4e-5, 0.0), zoo.optimizer)
    sched = zoo.lr_multiplier.multiplier
    check((sched.warmup_factor, round(sched.warmup_length * 184375, 6), zoo.lr_multiplier.base_lr) == (0.067, 500, 0.1), sched)

    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    per_step, snapshot = [], {}

    def groups(model):
        """stem, res5, FPN, heads (RPN + ROI heads)."""
        out = {"stem": {}, "res5": {}, "fpn": {}, "box_head": {}, "mask_head": {}}
        for k, p in model.named_parameters():
            for g, prefix in (("stem", "backbone.bottom_up.stem."), ("res5", "backbone.bottom_up.res5."),
                              ("fpn", "backbone.fpn_"), ("box_head", "roi_heads.box_head."),
                              ("mask_head", "roi_heads.mask_head.")):
                if k.startswith(prefix):
                    out[g][k] = p
        return out

    def before_train(trainer):
        for g, ps in groups(trainer.model).items():
            snapshot[g] = {k: p.detach().clone() for k, p in ps.items()}
        snapshot["stats"] = {k: v.clone() for k, v in trainer.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}

    def after_step(trainer):
        per_step.append((fwd_k.launches, bwd_k.launches))
        nms_rounds.append(nms_padded.rounds)

    recorded, nms_rounds = [], []
    pool_entry = poolers.roi_align_multilevel
    leftover = cuda_leftovers("before the run (earlier phases' leftovers)")
    torch.cuda.reset_peak_memory_stats()
    fwd_k.launches = bwd_k.launches = nms_padded.rounds = 0
    fwd_k.paths = {}
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    # 20 steps from scratch leave no score over the recipe's 0.05
    threshold = hooks.CallbackHook(before_train=lambda t: setattr(t.model.roi_heads.box_predictor, "test_score_thresh", 0.0))
    t0 = time.perf_counter()
    try:
        trainer = tool.main(args, extra_hooks=[threshold, hooks.CallbackHook(before_train=before_train, after_step=after_step)])
    finally:
        poolers.roi_align_multilevel = pool_entry
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_launches, bwd_launches = fwd_k.launches, bwd_k.launches
    model, storage = trainer.model, trainer.storage
    check(model.device.type == device.type and model.compute_dtype == torch.bfloat16, (model.device, model.compute_dtype))
    bns = get_bn_modules(model)
    check(len(bns) == LSJ_BN_COUNT and all(type(m) is SyncBatchNorm for m in bns), len(bns))
    check(all(p.requires_grad for p in model.parameters()), "a frozen parameter (FREEZE_AT is 0)")
    opt = trainer.optimizer
    check(type(opt).__name__ == "SGD" and {(g["lr"] > 0, g["weight_decay"]) for g in opt.param_groups} == {(True, 4e-5), (True, 0.0)},
          [(g["lr"], g["weight_decay"]) for g in opt.param_groups])
    norm_ids = {id(p) for m in bns for p in m.parameters()}
    check(all((g["weight_decay"] == 0.0) == (id(p) in norm_ids) for g in opt.param_groups for p in g["params"]),
          "the BN parameters and only they take weight_decay_norm 0")

    check(len(per_step) == LSJ_TRAIN_ITERS, len(per_step))
    steps = step_launches(per_step)
    check(all(s == (2, 2) for s in steps), f"per-step (B1, B2) launches {steps}")
    eval_fwd = fwd_launches - per_step[-1][0]
    check(eval_fwd == 2 * TRAINER_TEST_IMAGES, f"{eval_fwd} B1 launches over {TRAINER_TEST_IMAGES} eval images")
    check(bwd_launches == 2 * LSJ_TRAIN_ITERS and set(fwd_k.paths) == {"vector"}, (bwd_launches, fwd_k.paths))
    for k in LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == LSJ_TRAIN_ITERS and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))
    lrs = [v for v, _ in storage.history("lr").values()]
    check(math.isclose(lrs[0], 0.1 * 0.067, rel_tol=1e-6) and lrs[0] < lrs[-1] < 0.1 * 0.11, lrs)
    log(f"  lr over the steps: {lrs[0]:.4e} -> {lrs[-1]:.4e} (warmup from 0.067 x 0.1 over 500 steps)")
    moved = {}
    for g, ps in groups(model).items():
        changed = [k for k, p in ps.items() if not torch.equal(p.detach(), snapshot[g][k])]
        moved[g] = (len(changed), len(ps))
        check(ps and len(changed) == len(ps), f"{g}: {len(changed)} of {len(ps)} moved; unmoved {sorted(set(ps) - set(changed))[:8]}")
    log("  parameter tensors moved: " + ", ".join(f"{g} {a} of {b}" for g, (a, b) in moved.items()))
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    check(len(stats) == 2 * LSJ_BN_COUNT, len(stats))
    unmoved = [k for k, v in stats.items() if torch.equal(v, snapshot["stats"][k]) or
               (k.endswith("running_mean") and not v.abs().max() > 0) or (k.endswith("running_var") and torch.equal(v, torch.ones_like(v)))]
    check(not unmoved, f"running statistics left at 0 / 1: {unmoved[:8]}")
    log(f"  every one of the {len(bns)} SyncBN layers updated its running statistics ({len(stats)} tensors moved from 0 / 1)")
    aps = {}
    for task in ("bbox", "segm"):
        values = [storage.latest()[f"{task}/{k}"][0] for k in ("AP", "AP50", "AP75")]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        aps[task] = values[0]
    log(f"  {LSJ_TRAIN_ITERS} steps of {LSJ_TRAIN_BATCH} images + do_test over {TRAINER_TEST_IMAGES} images (running "
        f"statistics) in {train_s:.2f} s; bbox AP {aps['bbox']:.4f}, segm AP {aps['segm']:.4f}; launches B1 {fwd_launches} "
        f"({eval_fwd} in eval), B2 {bwd_launches}")
    step_stats = step_times(storage, LSJ_TRAIN_BATCH, card, peak)
    rounds = [b - a for a, b in zip([0] + nms_rounds[:-1], nms_rounds)]
    rpn = model.proposal_generator
    log(f"  NMS fixpoint rounds a step (RPN, 5 levels x {LSJ_TRAIN_BATCH} images, pre-NMS top-k "
        f"{rpn.pre_nms_topk[True]} / post {rpn.post_nms_topk[True]}): " + ", ".join(map(str, rounds)))

    # one fixed batch's train step, profiled: the BN passes against the NMS and the convolutions
    batch = next(trainer._data_loader_iter)
    optimizer, gen = trainer.optimizer, trainer.generator

    def one_step():
        losses = model(batch, train=True, generator=gen)
        optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        optimizer.step()

    profiled = bn_conv_profile(one_step, f"one {LSJ_TRAIN_BATCH}x1024x1024 LSJ train step")

    fwd, bwd = compare_recorded_pools(recorded, "LSJ train first-batch")

    # resume from the mid-run checkpoint: parameters, momentum and running statistics as saved
    out_dir = os.path.join(workdir, "lsj_train")
    ckpt = os.path.join(out_dir, f"model_{LSJ_TRAIN_CKPT - 1:07d}.pth")
    for name in (f"model_{LSJ_TRAIN_CKPT - 1:07d}.pth", f"model_{LSJ_TRAIN_ITERS - 1:07d}.pth", "model_final.pth"):
        check(os.path.exists(os.path.join(out_dir, name)), name)
    with open(os.path.join(out_dir, "last_checkpoint"), "w") as f:
        f.write(os.path.basename(ckpt))
    del trainer, model, optimizer, batch
    torch.cuda.empty_cache()
    args2 = lsj_train_args(tool, workdir, coco, train_name, test_name, LSJ_TRAIN_CKPT + 1, resume=True)
    cfg2 = LazyConfig.apply_overrides(LazyConfig.load(args2.config_file), args2.opts)
    del cfg2.dataloader["evaluator"]
    second, start = tool.build_trainer(args2, cfg2)
    check(start == LSJ_TRAIN_CKPT, start)
    saved = torch.load(ckpt, map_location=device, weights_only=False)
    state = second.model.state_dict()
    check(state.keys() == saved["model"].keys() and all(torch.equal(state[k], v) for k, v in saved["model"].items()),
          "the resumed model differs from the checkpoint")
    resumed_stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    check(len(resumed_stats) == 2 * LSJ_BN_COUNT and all(torch.equal(state[k], saved["model"][k]) for k in resumed_stats),
          "a resumed running statistic differs from the checkpoint")
    opt, ref_opt = second.optimizer.state_dict(), saved["trainer"]["optimizer"]
    check(opt["state"].keys() == ref_opt["state"].keys() and all(
        torch.equal(opt["state"][j]["momentum_buffer"], ref_opt["state"][j]["momentum_buffer"]) for j in ref_opt["state"]),
        "the resumed momentum buffers differ from the checkpoint")
    fwd_k.launches = bwd_k.launches = 0
    second.train(start, LSJ_TRAIN_CKPT + 1)
    torch.cuda.synchronize()
    check((fwd_k.launches, bwd_k.launches) == (2, 2), (fwd_k.launches, bwd_k.launches))
    resumed_loss = second.storage.history("total_loss").latest()
    check(math.isfinite(resumed_loss), resumed_loss)
    log(f"  resumed at iteration {start} from {os.path.basename(ckpt)}: parameters, {len(resumed_stats)} running statistics "
        f"and {len(ref_opt['state'])} momentum buffers bitwise equal to the checkpoint after the load; one step, total_loss "
        f"{resumed_loss:.4f}")
    del second
    torch.cuda.empty_cache()
    return {
        **{f"lsj_train_{k}": v for k, v in step_stats.items()},
        "lsj_train_images_per_step": LSJ_TRAIN_BATCH,
        "lsj_train_peak_gib": peak,
        "lsj_train_leftover_gib": leftover,
        "lsj_train_phase_s": time.perf_counter() - t_phase,
        "lsj_train_bbox_AP": aps["bbox"],
        "lsj_train_segm_AP": aps["segm"],
        **{f"lsj_train_profile_{k}" if k.endswith("_share") else f"lsj_train_profile_{k}_ms": v for k, v in profiled.items()},
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }


def phase_precise_bn(device, card: str, workdir: str, coco):
    """``tools/train_net.py`` training of ``Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml``
    (SyncBN in the ResNet, the FPN and the 4conv1fc box and mask heads,
    ``TEST.PRECISE_BN.ENABLED``, FREEZE_AT 2) from seeded weights (its R-50
    ``.pkl`` is a download) through DefaultTrainer at the yaml's own training
    input, cut to ``PRECISE_BN_ITERS`` steps and ``TEST.PRECISE_BN.NUM_ITER``
    = 4. Checks: the PreciseBN hook sits between LRScheduler and
    PeriodicCheckpointer and ran once, after the last step, over 4 batches;
    the statistics it wrote equal the mean over those batches of each BN
    input's mean and biased variance recomputed in float64; the frozen stem
    and res2 kept their parameters while their BNs updated their running
    statistics in the first step (ROADMAP C); B1 and B2 launched twice a
    step and held to their plain versions on the first batch; finite AP of
    the evaluation after training."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.engine import DefaultTrainer, hooks
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.layers import SyncBatchNorm, get_bn_modules
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda

    t_phase = time.perf_counter()
    json_file, image_root = coco
    train_name, test_name = "chip_smoke_precise_bn_train", "chip_smoke_precise_bn_test16"
    register_coco_instances(train_name, {}, json_file, image_root)
    register_coco_instances(test_name, {}, first_images(json_file, TRAINER_TEST_IMAGES, os.path.join(workdir, "pbn16.json")),
                            image_root)
    cfg = zoo_train_config(PRECISE_BN_CONFIG, train_name, test_name, os.path.join(workdir, "precise_bn"), PRECISE_BN_ITERS)
    check(cfg.TEST.PRECISE_BN.ENABLED and cfg.MODEL.BACKBONE.FREEZE_AT == 2 and cfg.MODEL.RESNETS.NORM == "SyncBN", cfg.TEST)
    cfg.MODEL.WEIGHTS = ""
    cfg.TEST.PRECISE_BN.NUM_ITER = PRECISE_BN_NUM_ITER

    class SmokeTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, distributed=False)

    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    kinds = [type(h).__name__ for h in trainer._hooks]
    check(kinds[:4] == ["IterationTimer", "LRScheduler", "PreciseBN", "PeriodicCheckpointer"], kinds)
    model = trainer.model
    bns = get_bn_modules(model)
    check(len(bns) == LSJ_BN_COUNT and all(type(m) is SyncBatchNorm for m in bns), len(bns))
    frozen = {k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad}
    check(frozen and {k.split(".")[2] for k in frozen} == {"stem", "res2"}, sorted(frozen)[:4])
    frozen_bns = [(n, m) for n, m in model.named_modules() if m in bns and n.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))]
    first_step = {}

    def after_first(t):
        if t.iter == 0:
            first_step.update({n: (m.running_mean.abs().max().item(), (m.running_var - 1).abs().max().item()) for n, m in frozen_bns})
        per_step.append((fwd_k.launches, bwd_k.launches))

    # the batches PreciseBN draws: each BN input's mean and biased variance in float64
    recomputed = {id(m): [] for m in bns}
    runs = []
    update = hooks.update_bn_stats

    def recording_update(model_, data_loader, num_iter, generator=None):
        def record(module, args):
            x = args[0].double()
            dims = [0, 2, 3]
            mean = x.mean(dims)
            recomputed[id(module)].append((mean, ((x - mean[None, :, None, None]) ** 2).mean(dims)))

        handles = [m.register_forward_pre_hook(record) for m in bns]
        try:
            update(model_, data_loader, num_iter, generator)
        finally:
            for h in handles:
                h.remove()
        runs.append(num_iter)

    per_step, recorded = [], []
    trainer.register_hooks([hooks.CallbackHook(after_step=after_first)])
    pool_entry = poolers.roi_align_multilevel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_k.launches = bwd_k.launches = 0
    hooks.update_bn_stats = recording_update
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    t0 = time.perf_counter()
    try:
        results = trainer.train()
    finally:
        hooks.update_bn_stats = update
        poolers.roi_align_multilevel = pool_entry
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_launches, bwd_launches = fwd_k.launches, bwd_k.launches

    check(runs == [PRECISE_BN_NUM_ITER], f"PreciseBN runs {runs}")
    # per step 2 + 2; PreciseBN's forwards (2 B1 launches each) run within the last step's hooks
    check(step_launches(per_step) == [(2, 2)] * (PRECISE_BN_ITERS - 1) + [(2 + 2 * PRECISE_BN_NUM_ITER, 2)],
          step_launches(per_step))
    # B1: 2 per step, 2 per PreciseBN forward (box and mask pools), 2 per eval image
    check(fwd_launches == 2 * (PRECISE_BN_ITERS + PRECISE_BN_NUM_ITER + TRAINER_TEST_IMAGES) and bwd_launches == 2 * PRECISE_BN_ITERS,
          (fwd_launches, bwd_launches))
    for k in LOSSES:
        values = [v for v, _ in trainer.storage.history(k).values()]
        check(len(values) == PRECISE_BN_ITERS and all(np.isfinite(values)), (k, values))
    worst = {"mean": 0.0, "var": 0.0}
    for m in bns:
        rec = recomputed[id(m)]
        check(len(rec) == PRECISE_BN_NUM_ITER, len(rec))
        mean = sum(r[0] for r in rec) / len(rec)
        var = sum(r[1] for r in rec) / len(rec)
        scale = (mean.abs() + var.sqrt()).max().item()
        dm = (m.running_mean.double() - mean).abs().max().item()
        dv = (m.running_var.double() - var).abs().max().item()
        check(dm <= 1e-4 * scale + 1e-6 and dv <= 1e-4 * (mean**2 + var).max().item() + 1e-6, (dm, dv, scale))
        worst["mean"], worst["var"] = max(worst["mean"], dm / scale), max(worst["var"], dv / (mean**2 + var).max().item())
    log(f"  PreciseBN ran once, after step {PRECISE_BN_ITERS}, over {PRECISE_BN_NUM_ITER} batches: every one of the "
        f"{len(bns)} BNs holds the mean of its batch statistics recomputed in float64 (worst relative error: mean "
        f"{worst['mean']:.2e}, variance {worst['var']:.2e})")
    params = dict(model.named_parameters())
    check(all(torch.equal(params[k], v) for k, v in frozen.items()), "a frozen parameter moved")
    check(len(first_step) == 1 + 3 * 3 + 1 and all(a > 0 and b > 0 for a, b in first_step.values()), first_step)
    log(f"  FREEZE_AT 2: {len(frozen)} frozen parameter tensors of the stem and res2 unchanged; their {len(first_step)} BNs "
        f"updated their running statistics in the first step (batch statistics, as the JAX package; d2 makes them FrozenBN)")
    check(set(results) == {"bbox", "segm"}, list(results))
    for task in ("bbox", "segm"):
        values = [results[task][k] for k in EVAL_KEYS]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
    log(f"  {PRECISE_BN_ITERS} steps + PreciseBN + evaluation in {train_s:.2f} s, peak {peak:.2f} GiB; bbox AP "
        f"{results['bbox']['AP']:.4f}, segm AP {results['segm']['AP']:.4f}; launches B1 {fwd_launches}, B2 {bwd_launches}")
    fwd, bwd = compare_recorded_pools(recorded, "PreciseBN run first-batch")
    del trainer, model
    torch.cuda.empty_cache()
    return {
        "precise_bn_phase_s": time.perf_counter() - t_phase,
        "precise_bn_train_s": train_s,
        "precise_bn_peak_gib": peak,
        "precise_bn_worst_rel_err": worst,
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }


# phases 26-28: the one-stage detectors and the RPN-only model (no RoIAlign,
# no attention on these paths)
RETINANET_CONFIG = "COCO-Detection/retinanet_R_50_FPN_3x.yaml"
FCOS_CONFIG = "COCO-Detection/fcos_R_50_FPN_1x.py"
# the FCOS file has only model and train; d2's FCOS config takes the rest
# from common/ as configs/COCO-Detection/retinanet_R_50_FPN_1x.py does
FCOS_RECIPE_FROM = "COCO-Detection/retinanet_R_50_FPN_1x.py"
RPN_FPN_CONFIG = "COCO-Detection/rpn_R_50_FPN_1x.yaml"
RPN_C4_CONFIG = "COCO-Detection/rpn_R_50_C4_1x.yaml"
DENSE_FORWARDS = 3  # timed batch forwards per model, after one warm forward
FCOS_TRAIN_ITERS = RPN_TRAIN_ITERS = 4  # 10 until phases 36-38 came, 6 until 39-40
RETINANET_LOSSES = ("loss_cls", "loss_box_reg")
FCOS_LOSSES = ("loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr")
RPN_LOSSES = ("loss_rpn_cls", "loss_rpn_loc")


def kernel_counters():
    """B1-B4's wrappers, whose ``launches`` count their kernels."""
    from detectron2_tpu_torch.ops import attention, roi_align

    return {
        "B1": roi_align.roi_align_multilevel_cuda,
        "B2": roi_align.roi_align_multilevel_backward_cuda,
        "B3": attention.flash_attention_cuda,
        "B4": attention.flash_attention_t_cuda,
    }


_ATTENTION_FREE = []  # the label of the attention_free block being run, if any


def zero_kernel_launches() -> None:
    """Every count to 0; inside ``attention_free``, B3/B4's counts are
    checked to be 0 first, so that no run's launches go unread."""
    if _ATTENTION_FREE:
        no_attention_launches(_ATTENTION_FREE[-1])
    for k in kernel_counters().values():
        k.launches = 0


@contextlib.contextmanager
def attention_free(label: str):
    """A block of phases whose paths launch neither B3 nor B4: their counts
    start at 0 and are checked at every zeroing inside it and at its end."""
    zero_kernel_launches()
    _ATTENTION_FREE.append(label)
    try:
        yield
        no_attention_launches(label)
    finally:
        _ATTENTION_FREE.pop()


def no_kernel_launches(label: str) -> dict:
    """None of B1-B4 may launch on a path without RoIAlign or attention."""
    counts = {name: k.launches for name, k in kernel_counters().items()}
    check(not any(counts.values()), f"{label}: B1-B4 launched on a dense path: {counts}")
    return counts


class _Patched:
    """Replace ``(owner, attribute)`` pairs by wrappers of their values for a
    ``with`` block; a method patched on a module instance is removed again,
    not left as an instance attribute."""

    def __init__(self, patches):
        self._patches = patches  # (owner, attribute, make_wrapper)

    def __enter__(self):
        self._saved = []
        for owner, attr, wrap in self._patches:
            own = attr in vars(owner)
            value = getattr(owner, attr)
            self._saved.append((owner, attr, own, value))
            setattr(owner, attr, wrap(value))
        return self

    def __exit__(self, *exc):
        for owner, attr, own, value in reversed(self._saved):
            if own:
                setattr(owner, attr, value)
            else:
                delattr(owner, attr)
        return False


def dense_parts(model):
    """(owner, attribute, part) of what a dense model's profile splits: the
    backbone with its FPN, the head (towers and predictors), the matching,
    the focal loss, the box losses, the decode's top-k and its NMS."""
    import detectron2_tpu_torch.modeling.meta_arch.dense_detector as dense
    import detectron2_tpu_torch.modeling.meta_arch.fcos as fcos
    import detectron2_tpu_torch.modeling.meta_arch.retinanet as retinanet
    from detectron2_tpu_torch.modeling.matcher import Matcher

    parts = [(model.backbone, "forward", "backbone"), (model.head, "forward", "head"),
             (dense, "top_k", "topk"), (dense, "batched_nms_padded", "nms")]
    if type(model).__name__ == "RetinaNet":
        parts += [(retinanet, "pairwise_iou", "matching"), (Matcher, "__call__", "matching"),
                  (retinanet, "sigmoid_focal_loss", "focal"),
                  (retinanet, "_dense_box_regression_loss", "box_loss")]
    else:
        parts += [(model, "match_points_to_gt", "matching"), (fcos, "sigmoid_focal_loss", "focal"),
                  (fcos, "giou_loss", "box_loss"), (fcos, "binary_cross_entropy_with_logits", "box_loss")]
    return parts


def ranged_profile(fn, label: str, parts) -> dict:
    """One call of ``fn`` under torch.profiler with each of ``parts`` in a
    ``record_function`` range ``d2t::<part>``. Forward device time of a part:
    the kernels that the operators inside its range launched (their self
    device time); each range also has a span on the device timeline, which
    is no kernel and stays out of the busy time; its convolutions':
    ``aten::convolution`` inside it; its backward: the autograd nodes whose
    forward op ran inside it (matched by sequence number), convolutions
    (``ConvolutionBackward0``) apart. Every ms is "not measured" when the
    profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name):
        def wrap(f):
            def run(*args, **kwargs):
                with record_function(f"d2t::{name}"):
                    return f(*args, **kwargs)

            return run

        return wrap

    with _Patched([(owner, attr, ranged(name)) for owner, attr, name in parts]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = sum(e.device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("d2t::")) / 1e3
    names = list(dict.fromkeys(name for _, _, name in parts))
    if busy == 0:
        log(f"  profiled {label}: the profiler saw no device time; the split is not measured")
        return {"busy_ms": "not measured", "wall_ms": wall_ms}

    def part_of(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("d2t::"):
                return p.name[5:]
            p = p.cpu_parent
        return None

    zero = dict.fromkeys(names + ["unattributed"], 0.0)
    fwd, conv_fwd, bwd, conv_bwd = dict(zero), dict(zero), dict(zero), dict(zero)
    seq = {}
    backward = []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("d2t::"):
            continue
        if e.name.startswith("autograd::engine::evaluate_function: "):
            backward.append(e)
        else:
            part = part_of(e)
            if part is None:
                continue
            fwd[part] += e.self_device_time_total / 1e3
            if e.sequence_nr >= 0:
                seq.setdefault(e.sequence_nr, part)
            if e.name == "aten::convolution":
                conv_fwd[part] += e.device_time_total / 1e3
    for e in backward:
        part = seq.get(e.sequence_nr, "unattributed")
        bwd[part] += e.device_time_total / 1e3
        if "ConvolutionBackward" in e.name:
            conv_bwd[part] += e.device_time_total / 1e3
    rest = busy - sum(fwd.values()) - sum(bwd.values())
    out = {"busy_ms": busy, "wall_ms": wall_ms, "fwd_ms": fwd, "conv_fwd_ms": conv_fwd, "rest_ms": rest}
    if backward:
        out.update(bwd_ms=bwd, conv_bwd_ms=conv_bwd)
    shown = ", ".join(
        f"{n} {fwd[n]:.1f}" + (f" (convs {conv_fwd[n]:.1f})" if conv_fwd[n] else "")
        + (f" + backward {bwd[n]:.1f}" + (f" (convs {conv_bwd[n]:.1f})" if conv_bwd[n] else "") if backward and bwd[n] else "")
        for n in names + ["unattributed"] if fwd[n] or bwd[n]
    )
    log(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.1%}); device ms by part: {shown}; "
        f"outside the parts {rest:.1f}")
    return out


def timed_nms(model, batch, owners):
    """One forward with each NMS call of ``owners`` ((module, attribute))
    synchronised on both sides: ms, calls, fixpoint rounds."""
    import torch

    from detectron2_tpu_torch.ops.nms import nms_padded

    rec = {"ms": 0.0, "calls": 0, "rounds": 0}

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            rounds, t0 = nms_padded.rounds, time.perf_counter()
            keep = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            rec["calls"] += 1
            rec["rounds"] += nms_padded.rounds - rounds
            return keep

        return run

    with _Patched([(owner, attr, timed) for owner, attr in owners]):
        model(batch)
    return rec


def dense_batch_forwards(model, batch, label: str, nms_owners):
    """One warm forward that counts the NMS rounds, ``DENSE_FORWARDS`` timed
    ones, one with the NMS synchronised and timed; returns (outputs, stats)."""
    import torch

    from detectron2_tpu_torch.ops.nms import nms_padded

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_padded.rounds = 0
    model(batch)
    torch.cuda.synchronize()
    rounds = nms_padded.rounds
    times = []
    for _ in range(DENSE_FORWARDS):
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    nms = timed_nms(model, batch, nms_owners)
    med = float(np.median(times))
    log(f"  {label} batch forward {B}x{H}x{W}: median {med:.1f} ms ({B / med * 1e3:.2f} img/s), "
        f"{min(times):.1f}-{max(times):.1f} ms over {DENSE_FORWARDS}; peak {peak:.2f} GiB; NMS {rounds} rounds in a forward, "
        f"{nms['ms']:.1f} ms in {nms['calls']} calls synchronised")
    return out, {"batch_ms": med, "batch_ms_range": [min(times), max(times)], "img_s": B / med * 1e3, "peak_gib": peak,
                 "nms_rounds": rounds, "nms_ms": nms["ms"]}


def check_dense_detections(out, max_det: int, expect_some: bool) -> list:
    """The padded detections of a 16 x 800x1344 batch: finite, at most
    ``max_det`` an image; after ``detector_postprocess`` every box inside
    the image. Returns the detections per image."""
    import torch

    from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

    check(out["pred_boxes"].shape == (B, max_det, 4) and torch.isfinite(out["pred_boxes"]).all(), out["pred_boxes"].shape)
    counts = out["valid"].sum(1).tolist()
    check(max(counts) <= max_det and (min(counts) > 0 if expect_some else True), counts)
    for i in range(B):
        inst = detector_postprocess({k: v[i] for k, v in out.items()}, H, W, H, W)
        boxes = inst.pred_boxes.tensor
        check(torch.isfinite(boxes).all() and (boxes >= 0).all() and (boxes[:, 0::2] <= W).all()
              and (boxes[:, 1::2] <= H).all() and len(inst) <= max_det, f"image {i}: boxes outside the image")
    return counts


def dense_request(predictor, label: str, expect_some: bool = True) -> list:
    """``DefaultPredictor`` on one 480x640 image, first call and steady."""
    import torch

    img = np.random.RandomState(1).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    request_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        boxes = inst.pred_boxes.tensor
        check((len(inst) > 0 or not expect_some) and len(inst) <= 100, len(inst))
        check(torch.isfinite(boxes).all() and (boxes >= 0).all() and (boxes[:, 0::2] <= 640).all()
              and (boxes[:, 1::2] <= 480).all(), f"{label}: request boxes outside the image")
        check(not inst.has("pred_masks") and not inst.has("pred_keypoints"), "a dense detector gives boxes only")
    log(f"  {label} request 480x640: {len(inst)} detections, first {request_ms[0]:.1f} ms, steady {request_ms[1]:.1f} ms")
    return request_ms


def profiled_train_step(model, batch, label: str):
    """One training forward and backward of ``batch`` (no optimizer step)
    under ``ranged_profile``; the gradients are dropped afterwards."""

    def step():
        losses = model(batch, train=True)
        sum(losses.values()).backward()

    out = ranged_profile(step, label, dense_parts(model))
    model.zero_grad(set_to_none=True)
    return out


def calibrate_on_train_images(model, yacs_cfg, dataset_name: str, n: int = 4) -> None:
    """FrozenBN statistics from ``n`` train images (phase 11's cut: seeded
    weights with identity statistics blow the activations up)."""
    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn

    calib = next(iter(build_detection_test_loader(yacs_cfg, dataset_name, batch_size=n)))
    calibrate_frozen_bn(model, {k: v for k, v in calib.items() if k != "metadata"})


def register_dense_sets(coco, workdir: str, prefix: str):
    from detectron2_tpu_torch.data.datasets import register_coco_instances

    json_file, image_root = coco
    train_name, test_name = f"{prefix}_train", f"{prefix}_test16"
    register_coco_instances(train_name, {}, json_file, image_root)
    register_coco_instances(test_name, {}, first_images(json_file, TRAINER_TEST_IMAGES, os.path.join(workdir, f"{prefix}16.json")),
                            image_root)
    return train_name, test_name


def phase_retinanet(device, card: str, workdir: str, coco):
    """RetinaNet R50-FPN 3x (``configs/COCO-Detection/retinanet_R_50_FPN_3x.yaml``
    as it is: 9 anchors a location, ~201k an image at 800x1344, an L1 box
    loss), bf16, seeded weights. Inference: DefaultPredictor on one image,
    and the 16 x 800x1344 batch at SCORE_THRESH_TEST 0 (5 x 1000 candidates
    an image into the NMS, the worst case), every box finite and inside the
    image after postprocess, at most 100 an image. Training: DefaultTrainer
    at the yaml's input (16 images, 640-800 / 1333, flips), 8 steps, a
    checkpoint at 4, a resume from it that restores the parameters, the
    momentum and ``loss_normalizer`` bitwise, finite AP over 8 images.
    Measures: batch ms, request ms, peak memory, median step and the
    loader's share, and one profiled batch forward and train step split by
    part. B1-B4 launch 0 times."""
    import torch

    from detectron2_tpu_torch.engine import DefaultTrainer, hooks
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    import detectron2_tpu_torch.modeling.meta_arch.dense_detector as dense

    t_phase = time.perf_counter()
    zero_kernel_launches()

    def thresh0(cfg):
        cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0

    cfg, predictor, batch = seeded_zoo_model(device, RETINANET_CONFIG, edit=thresh0)
    model = predictor.model
    check(type(model).__name__ == "RetinaNet" and model.anchor_generator.num_anchors == [9] * 5, model.anchor_generator.num_anchors)
    check(model.smooth_l1_beta == 0.0 and model.test_topk_candidates == 1000, "the yaml's RetinaNet")
    request_ms = dense_request(predictor, "RetinaNet")
    out, fwd = dense_batch_forwards(model, batch, "RetinaNet", [(dense, "batched_nms_padded")])
    n_anchors = sum(9 * math.ceil(H / s) * math.ceil(W / s) for s in (8, 16, 32, 64, 128))
    counts = check_dense_detections(out, cfg.TEST.DETECTIONS_PER_IMAGE, True)
    log(f"  {n_anchors} anchors an image; detections per image {counts}")
    fwd_profile = ranged_profile(lambda: model(batch), "RetinaNet batch forward", dense_parts(model))
    del predictor, model, out
    torch.cuda.empty_cache()

    train_name, test_name = register_dense_sets(coco, workdir, "chip_smoke_retinanet")
    tcfg = zoo_train_config(RETINANET_CONFIG, train_name, test_name, os.path.join(workdir, "retinanet"), TRAINER_ITERS)
    tcfg.MODEL.WEIGHTS = ""
    tcfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0
    tcfg.SOLVER.CHECKPOINT_PERIOD = TRAINER_CKPT_PERIOD

    class SmokeTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, distributed=False)

    trainer = SmokeTrainer(tcfg)
    trainer.resume_or_load(resume=False)
    calibrate_on_train_images(trainer.model, tcfg, train_name)
    normalizers = []
    trainer.register_hooks([hooks.CallbackHook(after_step=lambda t: normalizers.append(t.model.loss_normalizer.item()))])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    storage = trainer.storage
    for k in RETINANET_LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == TRAINER_ITERS and all(np.isfinite(values)), (k, values))
    check(len(normalizers) == TRAINER_ITERS and len(set(normalizers)) > 1, normalizers)
    check(set(results) == {"bbox"} and all(math.isfinite(results["bbox"][k]) for k in EVAL_KEYS), results)
    log(f"  {TRAINER_ITERS} steps + evaluation in {train_s:.2f} s; loss_normalizer {normalizers[0]:.3f} -> {normalizers[-1]:.3f}; "
        "EvalHook bbox: " + ", ".join(f"{k} {results['bbox'][k]:.4f}" for k in EVAL_KEYS))
    log("  total_loss: " + ", ".join(f"{v:.4f}" for v, _ in storage.history("total_loss").values()))
    stats = step_times(storage, tcfg.SOLVER.IMS_PER_BATCH, card, peak)
    step_batch = next(trainer._trainer._data_loader_iter)
    train_profile = profiled_train_step(trainer.model, step_batch, "RetinaNet train step (16 images)")

    # resume from the checkpoint at TRAINER_CKPT_PERIOD: parameters, momentum, loss_normalizer
    ckpt_name = f"model_{TRAINER_CKPT_PERIOD - 1:07d}.pth"
    ckpt9 = os.path.join(tcfg.OUTPUT_DIR, ckpt_name)
    with open(os.path.join(tcfg.OUTPUT_DIR, "last_checkpoint"), "w") as f:
        f.write(ckpt_name)
    cfg2 = tcfg.clone()
    cfg2.SOLVER.MAX_ITER = TRAINER_CKPT_PERIOD + 1
    cfg2.DATASETS.TEST = ()
    second = SmokeTrainer(cfg2)
    second.resume_or_load(resume=True)
    check(second.start_iter == TRAINER_CKPT_PERIOD, second.start_iter)
    saved = torch.load(ckpt9, map_location=device, weights_only=True)
    state = second.model.state_dict()
    check(state.keys() == saved["model"].keys() and all(torch.equal(state[k], v) for k, v in saved["model"].items()),
          "the resumed model differs from the checkpoint")
    check(torch.equal(second.model.loss_normalizer, saved["model"]["loss_normalizer"])
          and saved["model"]["loss_normalizer"].item() == normalizers[TRAINER_CKPT_PERIOD - 1],
          (second.model.loss_normalizer.item(), normalizers[TRAINER_CKPT_PERIOD - 1]))
    opt, ref = second.optimizer.state_dict(), saved["trainer"]["_trainer"]["optimizer"]
    check(opt["state"].keys() == ref["state"].keys() and all(
        torch.equal(opt["state"][j]["momentum_buffer"], ref["state"][j]["momentum_buffer"]) for j in ref["state"]),
        "the resumed momentum buffers differ from the checkpoint")
    second.train()
    check([i for _, i in second.storage.history("total_loss").values()] == [TRAINER_CKPT_PERIOD], "the resumed step")
    log(f"  resumed at iteration {second.start_iter}: parameters, momentum and loss_normalizer "
        f"({saved['model']['loss_normalizer'].item():.6f}) bitwise equal to the checkpoint; one step")
    launches = no_kernel_launches("phase 26")
    del second, trainer
    torch.cuda.empty_cache()
    return {
        **{f"retinanet_{k}": v for k, v in fwd.items()},
        "retinanet_request_ms": request_ms,
        "retinanet_anchors": n_anchors,
        "retinanet_forward_profile": fwd_profile,
        **{f"retinanet_train_{k}": v for k, v in stats.items()},
        "retinanet_train_peak_gib": peak,
        "retinanet_train_profile": train_profile,
        "retinanet_bbox_AP": results["bbox"]["AP"],
        "retinanet_launches": launches,
        "retinanet_phase_s": time.perf_counter() - t_phase,
    }


def fcos_train_args(tool, workdir: str, coco, train_name: str, test_name: str):
    """Phase 27's command line: ``configs/COCO-Detection/fcos_R_50_FPN_1x.py``
    as it is (``model``, ``train``) with ``--recipe-from
    retinanet_R_50_FPN_1x.py`` for its dataloader, optimizer and LR
    schedule, and the smoke run's cuts: 16 images a step,
    ``FCOS_TRAIN_ITERS`` steps, seed 0, seeded weights (its R-50 ``.pkl``
    is a download), the evaluation on TRAINER_TEST_IMAGES images."""
    args = lazy_train_args(tool, FCOS_CONFIG, "fcos", 16, FCOS_TRAIN_ITERS, workdir, coco, train_name, test_name,
                           FCOS_TRAIN_ITERS, extra=["train.init_checkpoint=''"])
    args.recipe_from = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", FCOS_RECIPE_FROM)
    return args


def phase_fcos(device, card: str, workdir: str, coco):
    """FCOS R50-FPN through ``LazyConfig``/``instantiate`` (the config's
    ``FCOS.from_config`` then ``clone(backbone=...)`` with P6/P7 from
    ``p5``), bf16, seeded weights. Inference at 16 x 800x1344 at its
    default score threshold (0.2) and at 0; training through
    ``lazyconfig_train_net`` (``fcos_train_args``): finite losses, moved parameters in
    the GN head, P6/P7 and res5 (the stem is frozen: the config's
    ``get_cfg()`` has FREEZE_AT 2), finite AP at threshold 0. Measures as
    phase 26."""
    import torch

    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.config import LazyConfig, instantiate
    from detectron2_tpu_torch.engine import DefaultPredictor, hooks
    from detectron2_tpu_torch.layers import GroupNorm
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights
    import detectron2_tpu_torch.modeling.meta_arch.dense_detector as dense
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    t_phase = time.perf_counter()
    zero_kernel_launches()
    train_name, test_name = "chip_smoke_fcos_train", "chip_smoke_fcos_test16"
    args = fcos_train_args(tool, workdir, coco, train_name, test_name)
    check(set(LazyConfig.load(args.config_file).keys()) == {"model", "train"}, "the FCOS config's keys")
    cfg = tool.load_config(args)
    check({"dataloader", "optimizer", "lr_multiplier"} <= set(cfg.keys()), list(cfg.keys()))

    model = instantiate(cfg.model).to(device)
    check(type(model).__name__ == "FCOS" and model.backbone.top_block.in_feature == "p5" and model.compute_dtype == torch.bfloat16,
          type(model).__name__)
    check(isinstance(model.head.cls_subnet[1], GroupNorm) and model.test_score_thresh == 0.2, "FCOS's GN head and threshold")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    images = torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[H, W]] * B, dtype=torch.int32, device=device)}
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    predictor = DefaultPredictor(model=model, min_size_test=800, max_size_test=1333)
    request_ms = dense_request(predictor, "FCOS (threshold 0.2)", expect_some=False)
    out, fwd = dense_batch_forwards(model, batch, "FCOS threshold 0.2", [(dense, "batched_nms_padded")])
    default_counts = check_dense_detections(out, 100, False)
    model.test_score_thresh = 0.0
    out, fwd0 = dense_batch_forwards(model, batch, "FCOS threshold 0", [(dense, "batched_nms_padded")])
    counts = check_dense_detections(out, 100, True)
    log(f"  detections per image at 0.2: {default_counts}; at 0: {counts}")
    fwd_profile = ranged_profile(lambda: model(batch), "FCOS batch forward (threshold 0)", dense_parts(model))
    del model, predictor, out
    torch.cuda.empty_cache()

    snapshot = {}

    def groups(m):
        prefixes = {"head": "head.", "p6p7": "backbone.top_block.", "res5": "backbone.bottom_up.res5.",
                    "stem": "backbone.bottom_up.stem."}
        return {g: {k: p for k, p in m.named_parameters() if k.startswith(pre)} for g, pre in prefixes.items()}

    yacs = model_zoo.get_config(RETINANET_CONFIG)  # its 800 / 1333 test resize, for the calibration batch

    def before_train(trainer):
        trainer.model.test_score_thresh = 0.0  # 10 steps from seeded weights leave no score over 0.2
        calibrate_on_train_images(trainer.model, yacs, train_name)
        snapshot.update({g: {k: p.detach().clone() for k, p in ps.items()} for g, ps in groups(trainer.model).items()})

    normalizers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = tool.main(args, extra_hooks=[hooks.CallbackHook(
        before_train=before_train, after_step=lambda t: normalizers.append(t.model.loss_normalizer.item()))])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    storage = trainer.storage
    for k in FCOS_LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == FCOS_TRAIN_ITERS and all(np.isfinite(values)), (k, values))
    moved = {}
    for g, ps in groups(trainer.model).items():
        moved[g] = max((p.detach() - snapshot[g][k]).abs().max().item() for k, p in ps.items())
    check(all(moved[g] > 0 for g in ("head", "p6p7", "res5")) and moved["stem"] == 0.0, moved)
    check(len(set(normalizers)) > 1, normalizers)
    # the EvalHook's evaluation after training (do_test over the 16 test images)
    results = {"bbox": {k: storage.history(f"bbox/{k}").latest() for k in EVAL_KEYS}}
    check(all(math.isfinite(v) for v in results["bbox"].values()), results)
    log(f"  {FCOS_TRAIN_ITERS} steps in {train_s:.2f} s; largest update: " + ", ".join(f"{g} {v:.3e}" for g, v in moved.items())
        + f"; loss_normalizer {normalizers[0]:.3f} -> {normalizers[-1]:.3f}; bbox AP {results['bbox']['AP']:.4f}")
    stats = step_times(storage, 16, card, peak)
    step_batch = next(trainer._data_loader_iter)
    train_profile = profiled_train_step(trainer.model, step_batch, "FCOS train step (16 images)")
    launches = no_kernel_launches("phase 27")
    del trainer
    torch.cuda.empty_cache()
    return {
        **{f"fcos_{k}": v for k, v in fwd.items()},
        **{f"fcos_thresh0_{k}": v for k, v in fwd0.items()},
        "fcos_request_ms": request_ms,
        "fcos_forward_profile": fwd_profile,
        **{f"fcos_train_{k}": v for k, v in stats.items()},
        "fcos_train_peak_gib": peak,
        "fcos_train_profile": train_profile,
        "fcos_bbox_AP": results["bbox"]["AP"],
        "fcos_launches": launches,
        "fcos_phase_s": time.perf_counter() - t_phase,
    }


def phase_proposal_network(device, card: str, workdir: str, coco):
    """The RPN-only model. ``rpn_R_50_FPN_1x.yaml`` through DefaultTrainer
    at its own input, ``RPN_TRAIN_ITERS`` steps from seeded weights, then
    ``DefaultTrainer.test`` with COCOEvaluator: finite AR@100 and AR@1000.
    ``rpn_R_50_C4_1x.yaml``: one 16 x 800x1344 batch forward (12000 pre-NMS
    boxes on its one level, 2000 after), the NMS's rounds and ms."""
    import torch

    from detectron2_tpu_torch.engine import DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    import detectron2_tpu_torch.modeling.proposal_generator.proposal_utils as proposal_utils

    t_phase = time.perf_counter()
    zero_kernel_launches()
    train_name, test_name = register_dense_sets(coco, workdir, "chip_smoke_rpn")
    tcfg = zoo_train_config(RPN_FPN_CONFIG, train_name, test_name, os.path.join(workdir, "rpn"), RPN_TRAIN_ITERS)
    tcfg.MODEL.WEIGHTS = ""

    class SmokeTrainer(DefaultTrainer):
        @classmethod
        def build_evaluator(cls, cfg, dataset_name):
            return COCOEvaluator(dataset_name, distributed=False)

    trainer = SmokeTrainer(tcfg)
    check(type(trainer.model).__name__ == "ProposalNetwork", type(trainer.model).__name__)
    trainer.resume_or_load(resume=False)
    calibrate_on_train_images(trainer.model, tcfg, train_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in RPN_LOSSES:
        values = [v for v, _ in trainer.storage.history(k).values()]
        check(len(values) == RPN_TRAIN_ITERS and all(np.isfinite(values)), (k, values))
    ar = results["box_proposals"]
    check(set(results) == {"box_proposals"} and math.isfinite(ar["AR@100"]) and math.isfinite(ar["AR@1000"]), results)
    log(f"  {RPN_TRAIN_ITERS} steps + DefaultTrainer.test in {train_s:.2f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in ar.items()))
    stats = step_times(trainer.storage, tcfg.SOLVER.IMS_PER_BATCH, card, peak)
    del trainer
    torch.cuda.empty_cache()

    cfg, predictor, batch = seeded_zoo_model(device, RPN_C4_CONFIG)
    model = predictor.model
    check(cfg.MODEL.RPN.PRE_NMS_TOPK_TEST == 12000 and model.proposal_generator.in_features == ("res4",), cfg.MODEL.RPN)
    out, fwd = dense_batch_forwards(model, batch, "RPN-only C4", [(proposal_utils, "nms_padded")])
    check(out["proposal_boxes"].shape == (B, 2000, 4) and torch.isfinite(out["proposal_boxes"]).all(), out["proposal_boxes"].shape)
    check(out["valid"].sum(1).min().item() > 0, "no proposals")
    launches = no_kernel_launches("phase 28")
    del predictor, model, out
    torch.cuda.empty_cache()
    return {
        "rpn_train_AR": ar,
        **{f"rpn_train_{k}": v for k, v in stats.items()},
        "rpn_train_peak_gib": peak,
        **{f"rpn_c4_{k}": v for k, v in fwd.items()},
        "rpn_launches": launches,
        "rpn_phase_s": time.perf_counter() - t_phase,
    }


DENSE_PHASES = (
    (26, "RetinaNet R50-FPN 3x, inference and DefaultTrainer training, full width", phase_retinanet),
    (27, "FCOS R50-FPN from the LazyConfig, inference and lazyconfig_train_net training, full width", phase_fcos),
    (28, "the RPN-only model: R50-FPN training and box-proposal AR, R50-C4 inference", phase_proposal_network),
)


def pools_entry(pools_results, per: str, extra=None):
    """One path's pools in the kernels line: the pools of one forward
    summed (times add; the bound of the summed work) and each pool."""
    names = list(pools_results)
    b_ms, b_by = bound(sum(pools_results[p]["bytes"] for p in names), sum(pools_results[p]["flops"] for p in names))
    entry = {
        "max_abs_err": max(pools_results[p]["max_abs_err"] for p in names),
        "ms": sum(pools_results[p]["ms"] for p in names),
        "plain_ms": sum(pools_results[p]["plain_ms"] for p in names),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "per_forward": per,
        "shapes": [
            {"pool": p, **{k: pools_results[p][k] for k in ("res", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "path")
                           if k in pools_results[p]}}
            for p in names
        ],
    }
    entry.update(extra or {})
    return entry


# phases 29-31: LVIS and Pascal VOC
LVIS_CONFIG = "LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
LVIS_VITDET_CONFIG = "ViTDet/LVIS/mask_rcnn_vitdet_b_100ep.py"
LVIS_CASCADE_CONFIG = "ViTDet/LVIS/cascade_mask_rcnn_vitdet_b_100ep.py"
VOC_FPN_CONFIG = "PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml"
VOC_C4_CONFIG = "PascalVOC-Detection/faster_rcnn_R_50_C4.yaml"
LVIS_CLASSES = 1203
# 8 val images (COCOeval over 1203 categories took 25-26 s at 32, 20 s at
# 24, 15.5 s at 16; 24 until phases 39-40 came, 16 until 43-44); 8 train
# images listed 128 times (1024 train entries), so that at LVIS's repeat
# threshold 0.001 a category in one entry repeats
LVIS_IMAGES, LVIS_TRAIN_REPEAT = 8, 128
LVIS_FORWARDS = 2  # timed batch forwards after the recorded one
LVIS_TRAIN_ITERS = 4  # 10 until phases 36-38 came, 6 until 39-40
LVIS_VITDET_ITERS, LVIS_VITDET_EVAL_IMAGES = 4, 4  # 6 steps until phases 39-40 came, 8 images until 41-42
FED_LOSS_CLASSES = 50
VOC_IMAGES, VOC_TRAIN_ITERS = 16, 4  # 10 steps until phases 36-38 came, 6 until 39-40
VOC_SPLITS = (("2007_trainval", 2007, "trainval"), ("2012_trainval", 2012, "trainval"), ("2007_test", 2007, "test"))


def lvis_data(workdir: str) -> dict:
    """The synthetic LVIS v1 tree (``testing.write_synthetic_lvis``)
    registered under the smoke run's names with LVIS v1's static metadata,
    as the builtin ``lvis_v1_*`` sets are, and the first images of its val
    json as a smaller set; returns the names, the val json, the seconds."""
    from detectron2_tpu_torch.data.datasets.lvis import get_lvis_instances_meta, register_lvis_instances
    from detectron2_tpu_torch.testing import write_synthetic_lvis

    t0 = time.perf_counter()
    tree = write_synthetic_lvis(os.path.join(workdir, "lvis"), LVIS_IMAGES, seed=7, train_repeat=LVIS_TRAIN_REPEAT)
    val8 = first_images(tree["val_json"], LVIS_VITDET_EVAL_IMAGES, os.path.join(workdir, "lvis_val8.json"))
    names = {"train": "chip_smoke_lvis_train", "val": "chip_smoke_lvis_val", "val8": "chip_smoke_lvis_val8"}
    meta = get_lvis_instances_meta("lvis_v1_train")
    for key, json_file in (("train", tree["train_json"]), ("val", tree["val_json"]), ("val8", val8)):
        register_lvis_instances(names[key], meta, json_file, tree["image_root"])
    return {**names, "val_json": tree["val_json"], "write_s": time.perf_counter() - t0}


def timing_evaluate(cls, seconds: list):
    """``cls.evaluate`` wrapped to append its seconds to ``seconds``."""
    evaluate = cls.evaluate

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = evaluate(self, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    return timed


def yaml_trainer(train_net):
    """``tools/train_net.py``'s Trainer (its ``build_evaluator`` picks COCO,
    LVIS or Pascal VOC by the dataset's ``evaluator_type``), without the
    tensorboard writer."""

    class SmokeTrainer(train_net.Trainer):
        def build_writers(self):
            return []

    return SmokeTrainer


def check_loss_values(storage, keys, iters: int) -> None:
    for k in keys:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == iters and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))


def phase_lvis(device, card: str, workdir: str):
    """Mask R-CNN R50-FPN on LVIS v1 from ``configs/LVISv1-InstanceSegmentation/
    mask_rcnn_R_50_FPN_1x.yaml`` as it is (1203 classes, SCORE_THRESH_TEST
    1e-4, 300 detections an image, RepeatFactorTrainingSampler at 0.001;
    bf16, seeded weights): (a) one recorded and LVIS_FORWARDS timed batch
    forwards at 16 x 800x1344 with the masks pasted on the device, B1 twice a
    forward and held on the recorded pools, the NMS loop's rounds and ms,
    the peak memory beside the 18.1 GB the mask logits would take if every
    class channel were cast to float32; (b) LVIS_TRAIN_ITERS DefaultTrainer
    steps at 16 images from the synthetic LVIS train set at the yaml's
    input, then its EvalHook through ``build_evaluator``'s LVISEvaluator over
    LVIS_IMAGES val images (AP, APr/APc/APf finite; COCOeval's seconds), B1
    and B2 twice a step and held on the first batch's pools and cotangents;
    (c) the val set's ground truth through LVISEvaluator: AP 100."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import DatasetCatalog, build_detection_test_loader
    from detectron2_tpu_torch.data.samplers import RepeatFactorTrainingSampler
    from detectron2_tpu_torch.evaluation import LVISEvaluator
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.ops.nms import nms_padded
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import ground_truth_detections
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    zoo = model_zoo.get_config(LVIS_CONFIG)
    rh, dl = zoo.MODEL.ROI_HEADS, zoo.DATALOADER
    check((rh.NUM_CLASSES, rh.SCORE_THRESH_TEST, zoo.TEST.DETECTIONS_PER_IMAGE, dl.SAMPLER_TRAIN, dl.REPEAT_THRESHOLD,
           zoo.DATASETS.TRAIN, zoo.DATASETS.TEST)
          == (LVIS_CLASSES, 1e-4, 300, "RepeatFactorTrainingSampler", 0.001, ("lvis_v1_train",), ("lvis_v1_val",)),
          f"{LVIS_CONFIG} as the zoo has it")
    data = lvis_data(workdir)
    log(f"  synthetic LVIS v1: {LVIS_IMAGES} train images listed {LVIS_TRAIN_REPEAT} times, {LVIS_IMAGES} val images, "
        f"1203 categories; written and registered in {data['write_s']:.2f} s")

    # (a) the batch forward at 16 x 800x1344, masks pasted on the device
    def paste(cfg):
        cfg.TPU.PASTE_MASKS_IN_GRAPH = True

    cfg, predictor, batch = seeded_zoo_model(device, LVIS_CONFIG, score_thresh=rh.SCORE_THRESH_TEST, edit=paste)
    model = predictor.model
    D = cfg.TEST.DETECTIONS_PER_IMAGE
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_k.launches = 0
    fwd_k.paths = {}
    nms_padded.rounds = 0
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 2)
    t0 = time.perf_counter()
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    rounds = nms_padded.rounds
    times = []
    for _ in range(LVIS_FORWARDS):
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    forward_launches, paths = fwd_k.launches, dict(fwd_k.paths)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(forward_launches == 2 * (1 + LVIS_FORWARDS) and paths == {"vector": forward_launches}, (forward_launches, paths))
    check(out["pred_boxes"].shape == (B, D, 4) and torch.isfinite(out["pred_boxes"]).all())
    check(out["pred_masks_full"].shape == (B, D, H, W) and out["pred_masks_full"].dtype == torch.bool)
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0 and int(out["pred_classes"][out["valid"]].max()) < LVIS_CLASSES, n_valid)
    n_classes = len(torch.unique(out["pred_classes"][out["valid"]]))
    full_cast_gb = B * D * 28 * 28 * LVIS_CLASSES * 4 / 1e9
    med = float(np.median(times))
    log(f"  batch forward {B}x{H}x{W}: first {first_ms:.1f} ms, then median {med:.1f} ms/batch ({B / med * 1e3:.2f} img/s) "
        f"over {LVIS_FORWARDS}; peak memory {peak:.2f} GiB (every mask class channel cast to float32 would add "
        f"{full_cast_gb:.1f} GB: {B}x{D}x28x28x{LVIS_CLASSES} float32); NMS loop rounds in one forward {rounds}; "
        f"detections per image {n_valid}, {n_classes} classes; B1 launches {forward_launches} {paths}")
    nms_ms = nms_timed_forward(model, batch)
    log("  NMS in one more forward, each call synchronised: " + ", ".join(
        f"{k} {v['ms']:.1f} ms in {v['calls']} calls, {v['rounds']} rounds" for k, v in nms_ms.items()))
    del out
    pools = compare_pools(recorded, ("box", "mask"), "LVIS R50-FPN")
    del model, predictor, batch
    torch.cuda.empty_cache()

    # (b) DefaultTrainer at the yaml's input, then its EvalHook with LVISEvaluator
    factors = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(DatasetCatalog.get(data["train"]), 0.001)
    factors = np.asarray(factors)
    log(f"  repeat factors at 0.001 over {len(factors)} train entries: {int((factors > 1).sum())} above 1, max "
        f"{factors.max():.4f}, mean {factors.mean():.4f}")
    check((factors > 1).any(), "no repeat factor above 1")
    cfg = zoo_train_config(LVIS_CONFIG, data["train"], data["val"], os.path.join(workdir, "lvis_trainer"), LVIS_TRAIN_ITERS,
                           sampler="RepeatFactorTrainingSampler")
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = rh.SCORE_THRESH_TEST
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * LVIS_TRAIN_ITERS
    t0 = time.perf_counter()
    trainer = yaml_trainer(train_net)(cfg)
    trainer.resume_or_load(resume=False)
    calib = next(iter(build_detection_test_loader(cfg, data["train"], batch_size=4)))
    calibrate_frozen_bn(trainer.model, {k: v for k, v in calib.items() if k != "metadata"})
    log(f"  DefaultTrainer built, seeded, FrozenBN calibrated on 4 train images in {time.perf_counter() - t0:.2f} s")
    head0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("roi_heads.")}
    eval_s, recorded = [], []
    results, steps, train_s, train_peak = train_counted(trainer, recorded, 2, LVISEvaluator, eval_s)
    fwd_launches, bwd_launches, paths = fwd_k.launches, bwd_k.launches, dict(fwd_k.paths)
    check(len(steps) == LVIS_TRAIN_ITERS, len(steps))
    check(all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    eval_launches = fwd_launches - sum(f for f, _ in steps)
    check(eval_launches == 2 * LVIS_IMAGES, f"{eval_launches} forward launches over {LVIS_IMAGES} eval images")
    check(bwd_launches == 2 * LVIS_TRAIN_ITERS and paths == {"vector": fwd_launches}, (bwd_launches, paths))
    check_loss_values(trainer.storage, LOSSES, LVIS_TRAIN_ITERS)
    unmoved = [k for k, p in trainer.model.named_parameters() if k in head0 and torch.equal(p.detach(), head0[k])]
    check(not unmoved, f"ROI head parameters that did not move: {unmoved}")
    keys = EVAL_KEYS + ("APr", "APc", "APf")
    check(set(results) == {"bbox", "segm"} and len(eval_s) == 1, (list(results), eval_s))
    aps = {}
    for task in ("bbox", "segm"):
        values = [results[task][k] for k in keys]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        aps[task] = results[task]
        log(f"  EvalHook LVISEvaluator {task}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(keys, values)))
    log(f"  {LVIS_TRAIN_ITERS} steps + evaluation of {LVIS_IMAGES} images in {train_s:.2f} s, of it LVISEvaluator.evaluate "
        f"(COCOeval over 1203 categories, bbox + segm, 300 detections an image) {eval_s[0]:.2f} s; B1 launches "
        f"{fwd_launches} ({eval_launches} in eval), B2 {bwd_launches}; every one of the {len(head0)} ROI head tensors moved")
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, train_peak)
    fwd, bwd = compare_recorded_pools(recorded, "LVIS first-batch")
    del trainer
    torch.cuda.empty_cache()

    # (c) the ground truth fed back through the evaluator
    by_image = {}
    for det in ground_truth_detections(data["val_json"]):
        det["category_id"] -= 1  # the model's contiguous ids
        by_image.setdefault(det["image_id"], []).append(det)
    perfect = LVISEvaluator(data["val"], distributed=False)
    perfect._predictions = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    perfect_res = perfect.evaluate()
    for task in ("bbox", "segm"):
        check(perfect_res[task]["AP"] == 100.0, (task, perfect_res[task]))
        check(all(abs(perfect_res[task][k] - 100.0) < 1e-9 for k in ("APr", "APc", "APf")), (task, perfect_res[task]))
    log(f"  ground truth as detections: bbox AP {perfect_res['bbox']['AP']}, segm AP {perfect_res['segm']['AP']}, "
        f"APr/APc/APf 100 (to 1e-9)")
    return {
        "data": data,
        "lvis_batch_ms": med,
        "lvis_first_batch_ms": first_ms,
        "lvis_img_s": B / med * 1e3,
        "lvis_peak_gib": peak,
        "lvis_full_cast_mask_logits_gb": full_cast_gb,
        "lvis_nms_rounds": rounds,
        "lvis_nms_ms": nms_ms,
        **{f"lvis_train_{k}": v for k, v in stats.items()},
        "lvis_train_peak_gib": train_peak,
        "lvis_eval_evaluate_s": eval_s[0],
        **{f"lvis_{task}_{k}": aps[task][k] for task in aps for k in ("AP", "APr", "APc", "APf")},
        "lvis_phase_s": time.perf_counter() - t_phase,
        "b1_launches": forward_launches + fwd_launches,
        "b2_launches": bwd_launches,
        "pools": pools,
        "fwd": fwd,
        "bwd": bwd,
    }


def fed_loss_recorder(fast_rcnn, counts: list):
    """A stand-in for ``fast_rcnn.fed_loss_class_mask`` that keeps, on the
    device, each call's count of kept classes beside the count the
    federated loss must keep: the appeared foreground classes plus
    ``max(F - n_appeared, 0)`` drawn ones (the background counted in
    ``n_appeared``), capped by the classes of nonzero weight."""
    import torch

    mask_fn = fast_rcnn.fed_loss_class_mask

    def recording(gumbel, gt_classes, valid, num_classes, num_fed_loss_classes, weights):
        mask = mask_fn(gumbel, gt_classes, valid, num_classes, num_fed_loss_classes, weights)
        C = num_classes
        appeared = torch.zeros(C + 1, dtype=torch.bool, device=mask.device)
        appeared[gt_classes[valid].long()] = True
        n_fg, n_appeared = appeared[:C].sum(), appeared.sum()
        drawable = ((weights > 0) & ~appeared[:C]).sum()
        expected = n_fg + torch.minimum((num_fed_loss_classes - n_appeared).clamp_min(0), drawable)
        counts.append(torch.stack([mask.sum(), expected, n_fg, n_appeared]))
        return mask

    return recording


def lvis_vitdet_args(tool, config: str, workdir: str, data: dict):
    """Phase 30's command line: the config as it is, on phase 29's data,
    with the smoke run's cuts (PERF.md section 4): 8 images a step,
    LVIS_VITDET_ITERS steps, the evaluation over LVIS_VITDET_EVAL_IMAGES."""
    opts = [
        f"dataloader.train.dataset.names={data['train']}",
        f"dataloader.test.dataset.names={data['val8']}",
        f"dataloader.evaluator.dataset_name={data['val8']}",
        f"dataloader.train.total_batch_size={VITDET_TRAIN_BATCH}",
        f"train.max_iter={LVIS_VITDET_ITERS}",
        f"train.checkpointer.period={10 * LVIS_VITDET_ITERS}",
        "train.eval_period=0",
        "train.seed=0",
        "train.log_period=1",
        f"train.output_dir={os.path.join(workdir, 'lvis_vitdet')}",
    ]
    return tool.argument_parser().parse_args(["--config-file", config] + opts)


def lvis_cascade_config(config: str):
    """The cascade ViTDet-B LVIS config as the zoo has it."""
    from detectron2_tpu_torch.config import LazyConfig

    return LazyConfig.load(config)


def phase_lvis_vitdet(device, card: str, workdir: str, data: dict):
    """ViTDet-B on LVIS: ``configs/ViTDet/LVIS/mask_rcnn_vitdet_b_100ep.py``
    as it is (sigmoid CE with the federated loss over 1203 classes, its
    weights from ``lvis_v1_train``'s builtin metadata; LSJ onto 1024x1024;
    RepeatFactorTrainingSampler at 0.001) through ``lazyconfig_train_net``
    on phase 29's synthetic LVIS at 8 images a step for LVIS_VITDET_ITERS
    steps, then its LVISEvaluator over LVIS_VITDET_EVAL_IMAGES images.
    Checks: finite losses, the heads and the ViT blocks moved, each step's
    fed-loss mask kept the count it must, B1/B2 twice and B3 12 times a
    step, held to their plain versions on the first step's pools,
    cotangents and blocks. Then one batch forward at 8 x 1024x1024 of
    ``cascade_mask_rcnn_vitdet_b_100ep.py`` (seeded weights): three stages
    whose probabilities are sigmoids, B1 four times (three box pools, the
    mask pool) and B3 12 times, B1 held on its pools."""
    import torch

    import detectron2_tpu_torch.modeling.backbone.vit as vit
    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.config import LazyConfig
    from detectron2_tpu_torch.data.detection_utils import get_fed_loss_cls_weights
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.modeling.roi_heads import fast_rcnn
    from detectron2_tpu_torch.ops import attention as A
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, "configs", LVIS_VITDET_CONFIG)
    zoo = LazyConfig.load(config)
    bp, loader = zoo.model.roi_heads.box_predictor, zoo.dataloader.train
    check((bp.num_classes, bp.use_sigmoid_ce, bp.use_fed_loss, bp.test_topk_per_image, zoo.model.backbone.net.embed_dim,
           loader.sampler.repeat_factors.repeat_thresh, loader.dataset.names)
          == (LVIS_CLASSES, True, True, 300, 768, 0.001, "lvis_v1_train"), f"{LVIS_VITDET_CONFIG} as the zoo has it")
    args = lvis_vitdet_args(tool, config, workdir, data)

    fwd_k, bwd_k, attn_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda, A.flash_attention_cuda
    per_step, counts, snapshot = [], [], {}

    def before_train(trainer):
        snapshot.update({k: p.detach().clone() for k, p in trainer.model.named_parameters()
                         if k.startswith(("roi_heads.", "backbone.net.blocks."))})

    attn_rec, recorded = {}, []
    attn_entry, pool_entry, mask_entry = vit.attention_with_rel_pos, poolers.roi_align_multilevel, fast_rcnn.fed_loss_class_mask
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_k.launches = bwd_k.launches = attn_k.launches = 0
    fwd_k.paths, attn_k.paths = {}, {}
    vit.attention_with_rel_pos = recording_attention(attn_entry, attn_rec, lambda: not per_step)
    poolers.roi_align_multilevel = recording_pools(poolers, recorded)
    fast_rcnn.fed_loss_class_mask = fed_loss_recorder(fast_rcnn, counts)
    t0 = time.perf_counter()
    try:
        trainer = tool.main(args, extra_hooks=[hooks.CallbackHook(
            before_train=before_train,
            after_step=lambda t: per_step.append((fwd_k.launches, bwd_k.launches, attn_k.launches)))])
    finally:
        vit.attention_with_rel_pos, poolers.roi_align_multilevel = attn_entry, pool_entry
        fast_rcnn.fed_loss_class_mask = mask_entry
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_launches, bwd_launches, attn_launches = fwd_k.launches, bwd_k.launches, attn_k.launches
    model, storage = trainer.model, trainer.storage
    predictor = model.roi_heads.box_predictor
    check(model.compute_dtype == torch.bfloat16 and predictor.use_sigmoid_ce and predictor.use_fed_loss, predictor)
    check(torch.equal(predictor.fed_loss_weights.cpu(), torch.from_numpy(get_fed_loss_cls_weights("lvis_v1_train", 0.5))),
          "the federated loss's weights are not lvis_v1_train's at power 0.5")
    blocks = sum(ATTN_PER_FORWARD.values())
    check(len(per_step) == LVIS_VITDET_ITERS, len(per_step))
    steps = [tuple(c - p for c, p in zip(cur, prev)) for cur, prev in zip(per_step, [(0, 0, 0)] + per_step[:-1])]
    check(all(s == (2, 2, blocks) for s in steps), f"per-step (B1, B2, B3) launches {steps}")
    eval_fwd, eval_attn = fwd_launches - per_step[-1][0], attn_launches - per_step[-1][2]
    check(eval_fwd == 2 * LVIS_VITDET_EVAL_IMAGES and eval_attn == blocks * LVIS_VITDET_EVAL_IMAGES, (eval_fwd, eval_attn))
    check(bwd_launches == 2 * LVIS_VITDET_ITERS and set(fwd_k.paths) == {"vector"}, (bwd_launches, fwd_k.paths))
    check(set(attn_k.paths) == set(ATTN_MAIN_PATHS.values()), attn_k.paths)
    check_loss_values(storage, VITDET_TRAIN_LOSSES, LVIS_VITDET_ITERS)
    # the federated loss: one mask a step, each keeping what it must
    check(len(counts) == LVIS_VITDET_ITERS, len(counts))
    kept = torch.stack(counts).cpu().tolist()
    check(all(k == e for k, e, _, _ in kept), f"(kept, expected, appeared fg, appeared with background) per step: {kept}")
    log("  fed-loss classes kept per step (appeared fg + drawn = kept; with background): " + ", ".join(
        f"{int(fg)} + {int(k - fg)} = {int(k)} ({int(na)})" for k, _, fg, na in kept))
    moved = sum(not torch.equal(p.detach(), snapshot[k]) for k, p in model.named_parameters() if k in snapshot)
    check(moved >= 0.9 * len(snapshot), f"{moved} of {len(snapshot)} ROI head and ViT block tensors moved")
    keys = ("AP", "AP50", "AP75", "APr", "APc", "APf")
    aps = {}
    for task in ("bbox", "segm"):
        values = [storage.latest()[f"{task}/{k}"][0] for k in keys]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        aps[task] = values[0]
        log(f"  LVISEvaluator {task} over {LVIS_VITDET_EVAL_IMAGES} images: " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(keys, values)))
    log(f"  {LVIS_VITDET_ITERS} steps + do_test in {train_s:.2f} s; {moved} of {len(snapshot)} ROI head and ViT block "
        f"tensors moved; launches B1 {fwd_launches} ({eval_fwd} in eval), B2 {bwd_launches}, B3 {attn_launches} "
        f"({eval_attn} in eval)")
    stats = step_times(storage, VITDET_TRAIN_BATCH, card, peak)
    fwd, bwd = compare_recorded_pools(recorded, "ViTDet-B LVIS first-batch")
    attn = compare_recorded_attention(attn_rec, "ViTDet-B LVIS train", device)
    del trainer, model, storage
    torch.cuda.empty_cache()

    # one batch forward of the cascade config, its three stages' probabilities sigmoids
    cfg = lvis_cascade_config(os.path.join(here, "configs", LVIS_CASCADE_CONFIG))
    check(all(p.use_sigmoid_ce and p.use_fed_loss and p.num_classes == LVIS_CLASSES for p in cfg.model.roi_heads.box_predictor),
          "the cascade config's predictors")
    model = tool.build_model(cfg)
    check(model.device.type == device.type, model.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(30)
    images = torch.randint(0, 256, (VIT_B, VIT_HW, VIT_HW, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[VIT_HW, VIT_HW]] * VIT_B, dtype=torch.int32, device=device)}
    probs_checked = []
    predict_probs = fast_rcnn.FastRCNNOutputLayers.predict_probs

    def checked_probs(self, predictions):
        probs = predict_probs(self, predictions)
        probs_checked.append(bool(torch.equal(probs, torch.sigmoid(predictions[0]))) and probs.shape[-1] == LVIS_CLASSES + 1)
        return probs

    recorded = []
    fwd_k.launches = attn_k.launches = 0
    fwd_k.paths, attn_k.paths = {}, {}
    torch.cuda.reset_peak_memory_stats()
    fast_rcnn.FastRCNNOutputLayers.predict_probs = checked_probs
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 4)
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            out = model(batch)
            torch.cuda.synchronize()
            cascade_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fast_rcnn.FastRCNNOutputLayers.predict_probs = predict_probs
        poolers.roi_align_multilevel = pool_entry
    cascade_peak = torch.cuda.max_memory_allocated() / 2**30
    check(probs_checked == [True] * 6, f"stage probabilities that are sigmoids, per call: {probs_checked}")
    cascade_launches = (fwd_k.launches, attn_k.launches)
    check(cascade_launches == (8, 2 * blocks) and set(fwd_k.paths) == {"vector"}, (cascade_launches, fwd_k.paths))
    D = cfg.model.roi_heads.box_predictor[-1].test_topk_per_image
    check(out["pred_boxes"].shape == (VIT_B, D, 4) and torch.isfinite(out["pred_boxes"]).all(), out["pred_boxes"].shape)
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    log(f"  cascade ViTDet-B LVIS forward {VIT_B}x{VIT_HW}x{VIT_HW}: first {first_ms:.1f} ms, second {cascade_ms:.1f} ms, "
        f"peak {cascade_peak:.2f} GiB; 3 stages x 2 forwards of sigmoid probabilities over {LVIS_CLASSES + 1} columns; "
        f"detections per image {n_valid}; launches B1 {cascade_launches[0]} (4 a forward), B3 {cascade_launches[1]}")
    with torch.inference_mode():
        cascade_pools = compare_pools(recorded, ("box stage 1", "box stage 2", "box stage 3", "mask"), "cascade ViTDet-B LVIS")
    del model, out, batch
    torch.cuda.empty_cache()
    return {
        **{f"lvis_vitdet_train_{k}": v for k, v in stats.items()},
        "lvis_vitdet_train_peak_gib": peak,
        "lvis_vitdet_bbox_AP": aps["bbox"],
        "lvis_vitdet_segm_AP": aps["segm"],
        "lvis_vitdet_fed_loss_kept": [int(k) for k, _, _, _ in kept],
        "lvis_cascade_batch_ms": cascade_ms,
        "lvis_cascade_first_batch_ms": first_ms,
        "lvis_cascade_peak_gib": cascade_peak,
        "lvis_vitdet_phase_s": time.perf_counter() - t_phase,
        "b1_launches": fwd_launches + cascade_launches[0],
        "b2_launches": bwd_launches,
        "b3_launches": attn_launches + cascade_launches[1],
        "fwd": fwd,
        "bwd": bwd,
        "attn": attn,
        "cascade_pools": cascade_pools,
    }


def phase_voc(device, card: str, workdir: str):
    """Pascal VOC: ``faster_rcnn_R_50_FPN.yaml`` as it is (20 classes, no
    masks; bf16, seeded weights) through DefaultTrainer, VOC_TRAIN_ITERS
    steps at 16 images from the synthetic VOC 2007 + 2012 trainval at the
    yaml's input (480-800 / 1333, flips), then its EvalHook through
    ``build_evaluator``'s PascalVOCDetectionEvaluator on the 2007 test split
    (11-point AP, AP / AP50 / AP75 finite; the evaluation's seconds); B1 and
    B2 once a step (the box pool only), held on the first batch; the test
    split's ground truth through the evaluator's ``process``: AP50 100.
    Then ``faster_rcnn_R_50_C4.yaml``: one recorded and one timed batch
    forward at 16 x 800x1344, B1 once a forward on res4 (1024 channels),
    held on its pool."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import DatasetCatalog, build_detection_test_loader
    from detectron2_tpu_torch.data.datasets import register_pascal_voc
    from detectron2_tpu_torch.evaluation import PascalVOCDetectionEvaluator
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import write_synthetic_voc
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    t0 = time.perf_counter()
    root = write_synthetic_voc(os.path.join(workdir, "voc"), VOC_IMAGES, seed=31)
    names = {}
    for key, year, split in VOC_SPLITS:
        names[key] = f"chip_smoke_voc_{key}"
        register_pascal_voc(names[key], os.path.join(root, f"VOC{year}"), split, year)
    log(f"  synthetic VOC 2007 trainval + test and 2012 trainval, {VOC_IMAGES} images each; written in "
        f"{time.perf_counter() - t0:.2f} s")
    zoo = model_zoo.get_config(VOC_FPN_CONFIG)
    check((zoo.MODEL.ROI_HEADS.NUM_CLASSES, zoo.MODEL.MASK_ON, zoo.DATASETS.TRAIN, zoo.DATASETS.TEST)
          == (20, False, ("voc_2007_trainval", "voc_2012_trainval"), ("voc_2007_test",)), f"{VOC_FPN_CONFIG} as the zoo has it")
    cfg = zoo_train_config(VOC_FPN_CONFIG, names["2007_trainval"], names["2007_test"], os.path.join(workdir, "voc_trainer"),
                           VOC_TRAIN_ITERS, min_sizes=tuple(range(480, 801, 32)))
    cfg.DATASETS.TRAIN = (names["2007_trainval"], names["2012_trainval"])
    cfg.MODEL.WEIGHTS = ""
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * VOC_TRAIN_ITERS
    trainer = yaml_trainer(train_net)(cfg)
    trainer.resume_or_load(resume=False)
    calib = next(iter(build_detection_test_loader(cfg, names["2007_trainval"], batch_size=4)))
    calibrate_frozen_bn(trainer.model, {k: v for k, v in calib.items() if k != "metadata"})
    head0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("roi_heads.")}
    eval_s, recorded = [], []
    results, steps, train_s, peak = train_counted(trainer, recorded, 1, PascalVOCDetectionEvaluator, eval_s)
    fwd_launches, bwd_launches, paths = fwd_k.launches, bwd_k.launches, dict(fwd_k.paths)
    check(len(steps) == VOC_TRAIN_ITERS, len(steps))
    check(all(s == (1, 1) for s in steps), f"per-step (forward, backward) launches {steps}")
    eval_launches = fwd_launches - sum(f for f, _ in steps)
    check(eval_launches == VOC_IMAGES and bwd_launches == VOC_TRAIN_ITERS and paths == {"vector": fwd_launches},
          (eval_launches, bwd_launches, paths))
    check_loss_values(trainer.storage, ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"), VOC_TRAIN_ITERS)
    unmoved = [k for k, p in trainer.model.named_parameters() if k in head0 and torch.equal(p.detach(), head0[k])]
    check(not unmoved, f"ROI head parameters that did not move: {unmoved}")
    check(list(results) == ["bbox"] and len(eval_s) == 1, (list(results), eval_s))
    ap = results["bbox"]
    check(all(math.isfinite(ap[k]) and 0 <= ap[k] <= 100 for k in ("AP", "AP50", "AP75")), ap)
    log(f"  {VOC_TRAIN_ITERS} steps + evaluation of {VOC_IMAGES} images in {train_s:.2f} s: PascalVOCDetectionEvaluator "
        f"(2007, 11-point) AP {ap['AP']:.4f}, AP50 {ap['AP50']:.4f}, AP75 {ap['AP75']:.4f}, evaluate {eval_s[0]:.2f} s; "
        f"B1 launches {fwd_launches} ({eval_launches} in eval), B2 {bwd_launches}")
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, peak)
    fwd, bwd = compare_recorded_pools(recorded, "VOC first-batch", keys=(BOX_RES,))
    del trainer
    torch.cuda.empty_cache()

    # the test split's ground truth through process: AP50 100
    perfect = PascalVOCDetectionEvaluator(names["2007_test"])
    for rec in DatasetCatalog.get(names["2007_test"]):
        n = len(rec["annotations"])
        boxes = torch.zeros((1, max(n, 1), 4), device=device)
        classes = torch.zeros((1, max(n, 1)), dtype=torch.int64, device=device)
        if n:
            boxes[0, :n] = torch.tensor([a["bbox"] for a in rec["annotations"]], device=device)
            classes[0, :n] = torch.tensor([a["category_id"] for a in rec["annotations"]], device=device)
        perfect.process(
            {"image_sizes": torch.tensor([[rec["height"], rec["width"]]]),
             "metadata": [{"image_id": rec["image_id"], "height": rec["height"], "width": rec["width"]}]},
            {"pred_boxes": boxes, "scores": torch.ones((1, max(n, 1)), device=device), "pred_classes": classes,
             "valid": torch.arange(max(n, 1), device=device)[None] < n},
        )
    perfect_res = perfect.evaluate()["bbox"]
    check(all(abs(perfect_res[k] - 100.0) < 1e-9 for k in ("AP", "AP50", "AP75")), perfect_res)
    log(f"  ground truth through process: AP {perfect_res['AP']}, AP50 {perfect_res['AP50']}, AP75 {perfect_res['AP75']}")

    # the C4 model: one recorded and one timed batch forward, B1 on res4
    cfg, predictor, batch = seeded_zoo_model(device, VOC_C4_CONFIG)
    model = predictor.model
    recorded = []
    fwd_k.launches = 0
    fwd_k.paths = {}
    torch.cuda.reset_peak_memory_stats()
    kernel_entry = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 1)
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    c4_ms = (time.perf_counter() - t0) * 1e3
    c4_peak = torch.cuda.max_memory_allocated() / 2**30
    c4_launches = fwd_k.launches
    check(c4_launches == 2 and fwd_k.paths == {"vector": 2}, (c4_launches, fwd_k.paths))
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0 and torch.isfinite(out["pred_boxes"]).all(), n_valid)
    log(f"  VOC C4 batch forward {B}x{H}x{W}: {c4_ms:.1f} ms ({B / c4_ms * 1e3:.2f} img/s), peak {c4_peak:.2f} GiB; "
        f"detections per image {n_valid}; B1 launches {c4_launches} (the res4 pool once a forward)")
    c4_pools = compare_pools(recorded, ("res4",), "VOC C4")
    check(recorded == [] and c4_pools["res4"]["res"] == 14, c4_pools)
    del model, predictor, out, batch
    torch.cuda.empty_cache()
    return {
        **{f"voc_train_{k}": v for k, v in stats.items()},
        "voc_train_peak_gib": peak,
        "voc_AP": ap["AP"],
        "voc_AP50": ap["AP50"],
        "voc_AP75": ap["AP75"],
        "voc_evaluate_s": eval_s[0],
        "voc_c4_batch_ms": c4_ms,
        "voc_c4_peak_gib": c4_peak,
        "voc_phase_s": time.perf_counter() - t_phase,
        "b1_launches": fwd_launches + c4_launches,
        "b2_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
        "c4_pools": c4_pools,
    }


LVIS_VOC_PHASES = (
    (29, "LVIS v1 Mask R-CNN R50-FPN: batch forward, DefaultTrainer and LVISEvaluator, full width", phase_lvis),
    (30, "ViTDet-B on LVIS with sigmoid CE and the federated loss (lazyconfig_train_net), and the cascade forward",
     phase_lvis_vitdet),
    (31, "Pascal VOC: R50-FPN DefaultTrainer with the VOC evaluator, R50-C4 batch forward", phase_voc),
)


def run_lvis_voc_phases(timed, device, card: str, workdir: str) -> dict:
    """Phases 29-31 in order; phase 30 trains on phase 29's data."""
    import torch

    out = {}
    for n, title, fn in LVIS_VOC_PHASES:
        args = (device, card, workdir) + ((out[29]["data"],) if n == 30 else ())
        out[n] = timed(n, title, fn, *args)
        torch.cuda.empty_cache()
    return out


# phases 32-33: semantic and panoptic segmentation
PANOPTIC_CONFIG = "COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml"
PANOPTIC_LAZY_CONFIG = "COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.py"
SEMANTIC_CONFIG = "Misc/semantic_R_50_FPN_1x.yaml"
SEG_IMAGES = 8  # per split of the synthetic COCO panoptic tree (val_100 holds the same); 16 until phases 41-42 came
SEG_FORWARDS = 2  # timed batch forwards after the recorded one
SEG_TRAIN_ITERS, SEG_TRAIN_CKPT = 4, 2  # 10 and 5 until phases 36-38 came, 6 and 3 until 39-40
SEG_CLASSES = 54  # the stuff labels: things 0, 53 stuff classes
PANOPTIC_LOSSES = ("loss_sem_seg",) + LOSSES


def seg_data() -> dict:
    """The synthetic COCO panoptic tree (``testing.write_synthetic_coco_panoptic``)
    under the run's ``$DETECTRON2_DATASETS``, where the builtin
    ``coco_2017_*_panoptic*`` names already point; returns their names and
    the seconds of the write."""
    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.testing import write_synthetic_coco_panoptic

    t0 = time.perf_counter()
    root = os.environ["DETECTRON2_DATASETS"]
    tree = write_synthetic_coco_panoptic(root, SEG_IMAGES, seed=3)
    names = {
        "train": "coco_2017_train_panoptic_separated", "val": "coco_2017_val_100_panoptic_separated",
        "stuff_train": "coco_2017_train_panoptic_stuffonly", "stuff_val": "coco_2017_val_100_panoptic_stuffonly",
    }
    for name in names.values():
        check(MetadataCatalog.get(name).image_root.startswith(root), f"{name} is not under {root}")
    return {**names, "tree": tree, "write_s": time.perf_counter() - t0}


def seg_requests(predictor, expect: set, label: str) -> list:
    """``DefaultPredictor`` on one 480x640 image, twice (the first call
    includes cuDNN's search): d2's outputs at the image's size."""
    import torch

    img = np.random.RandomState(1).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    request_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = predictor(img)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(set(out) == expect, (label, sorted(out)))
        check(out["sem_seg"].shape == (SEG_CLASSES, 480, 640) and torch.isfinite(out["sem_seg"]).all())
        if "instances" in out:
            check_instances(out["instances"], len(out["instances"]), 480, 640)
        if "panoptic_seg" in out:
            pan, info = out["panoptic_seg"]
            check(pan.shape == (480, 640) and pan.dtype == np.int32 and len(info) == len(np.unique(pan[pan > 0])), label)
    log(f"  {label} request 480x640: first {request_ms[0]:.1f} ms, steady {request_ms[1]:.1f} ms")
    return request_ms


def seg_batch_forwards(model, batch, label: str, recorded=None, n_pools: int = 0) -> dict:
    """One forward at 16 x 800x1344 (recording ``n_pools`` pools into
    ``recorded``) and SEG_FORWARDS timed ones: ms, img/s, peak memory; the
    logits' shape and finiteness."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers

    kernel_entry = poolers.roi_align_multilevel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if n_pools:
        poolers.roi_align_multilevel = recording_entry(poolers, recorded, n_pools)
    t0 = time.perf_counter()
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(SEG_FORWARDS):
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    sem = out["sem_seg"]
    check(sem.shape == (B, H, W, SEG_CLASSES) and sem.dtype == torch.float32 and torch.isfinite(sem).all(), sem.shape)
    med = float(np.median(times))
    log(f"  {label} batch forward {B}x{H}x{W}: first {first_ms:.1f} ms, then median {med:.1f} ms/batch "
        f"({B / med * 1e3:.2f} img/s) over {SEG_FORWARDS}; peak memory {peak:.2f} GiB (the logits alone "
        f"{sem.numel() * 4 / 2**30:.2f} GiB)")
    return {"out": out, "first_ms": first_ms, "batch_ms": med, "img_s": B / med * 1e3, "peak_gib": peak}


def seg_trainer(train_net, config_name: str, train_name: str, test_name, out_dir: str, ckpt: int):
    """DefaultTrainer of a zoo yaml at its own input (phase 11's cuts), its
    FrozenBN statistics calibrated on 4 train images; with ``test_name``
    None, no evaluation after training."""
    cfg = zoo_train_config(config_name, train_name, test_name or train_name, out_dir, SEG_TRAIN_ITERS)
    cfg.MODEL.WEIGHTS = ""
    if test_name is None:
        cfg.DATASETS.TEST = ()
    cfg.SOLVER.CHECKPOINT_PERIOD = ckpt
    trainer = yaml_trainer(train_net)(cfg)
    trainer.resume_or_load(resume=False)
    calibrate_on_train_images(trainer.model, cfg, train_name)
    return cfg, trainer


def no_attention_launches(label: str) -> None:
    """B3 and B4 (attention) have no launch on a ResNet path."""
    counts = {name: k.launches for name, k in kernel_counters().items() if name in ("B3", "B4")}
    check(not any(counts.values()), f"{label}: attention kernels launched: {counts}")


def moved(model, before: dict) -> None:
    import torch

    unmoved = [k for k, p in model.named_parameters() if k in before and torch.equal(p.detach(), before[k])]
    check(not unmoved, f"parameters that did not move: {unmoved}")


def one_hot_logits(labels: np.ndarray, device):
    """``[1, h, w, 54]`` logits whose argmax is ``labels`` (255 -> 0)."""
    import torch

    lab = torch.as_tensor(labels.astype(np.int64), device=device)
    lab = torch.where(lab == 255, torch.zeros_like(lab), lab)
    return torch.nn.functional.one_hot(lab, SEG_CLASSES).float()[None]


def sem_seg_ground_truth(device, dataset_name: str) -> dict:
    """The stuff labels fed back through SemSegEvaluator.process as
    one-hot logits on the card: mIoU, fwIoU, mACC, pACC 100."""
    import torch

    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.data.png import read_png
    from detectron2_tpu_torch.evaluation import SemSegEvaluator

    ev = SemSegEvaluator(dataset_name)
    ev.reset()
    for d in DatasetCatalog.get(dataset_name):
        gt = read_png(d["sem_seg_file_name"])
        h, w = gt.shape
        ev.process({"image_sizes": torch.tensor([[h, w]]), "metadata": [{"file_name": d["file_name"], "height": h, "width": w}]},
                   {"sem_seg": one_hot_logits(gt, device)})
    res = ev.evaluate()["sem_seg"]
    check(all(res[k] == 100.0 for k in ("mIoU", "fwIoU", "mACC", "pACC")), {k: res[k] for k in ("mIoU", "fwIoU", "mACC", "pACC")})
    return res


def phase_panoptic(device, card: str, workdir: str, data: dict):
    """PanopticFPN R50-FPN from ``configs/COCO-PanopticSegmentation/
    panoptic_fpn_R_50_3x.yaml`` as it is (80 thing and 54 stuff classes, sem-seg
    loss weight 0.5; bf16, seeded weights): (a) DefaultPredictor requests
    (``instances``, ``sem_seg``, ``panoptic_seg``) and one recorded and
    SEG_FORWARDS timed batch forwards at 16 x 800x1344, B1 twice a forward,
    held on the recorded box and mask pools; (b) DefaultTrainer through
    ``tools/train_net.py``'s Trainer, SEG_TRAIN_ITERS steps at 16 images from
    the synthetic ``coco_2017_train_panoptic_separated`` at the yaml's input,
    a checkpoint every SEG_TRAIN_CKPT, B1 and B2 twice a step, held on the
    first batch's pools and cotangents, losses finite, the heads moved; (c)
    ``train_net --eval-only`` of the final checkpoint on
    ``coco_2017_val_100_panoptic_separated`` through ``build_evaluator``'s
    SemSegEvaluator, COCOEvaluator and COCOPanopticEvaluator (the panoptic
    fusion on the host); (d) ``lazyconfig_train_net --eval-only`` of
    ``panoptic_fpn_R_50_1x.py`` (``get_cfg()``'s 14x14 box pool, no fc) with
    seeded, calibrated weights over the same images, B1 held on its first
    image's 14x14 box pool and mask pool; (e) the ground truth fed back:
    PQ, mIoU and bbox AP 100."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.checkpoint import DetectionCheckpointer
    from detectron2_tpu_torch.config import LazyConfig, instantiate
    from detectron2_tpu_torch.data import MetadataCatalog, build_detection_test_loader
    from detectron2_tpu_torch.data.png import read_png
    from detectron2_tpu_torch.evaluation import COCOEvaluator, COCOPanopticEvaluator, SemSegEvaluator
    from detectron2_tpu_torch.evaluation.panoptic_evaluation import rgb2id
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import ground_truth_detections
    from detectron2_tpu_torch.tools import lazyconfig_train_net, train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    log(f"  synthetic COCO panoptic: {SEG_IMAGES} train and {SEG_IMAGES} val images under $DETECTRON2_DATASETS "
        f"(the builtin names), written in {data['write_s']:.2f} s")

    # (a) requests and batch forwards
    cfg, predictor, batch = seeded_zoo_model(device, PANOPTIC_CONFIG)
    check((cfg.MODEL.META_ARCHITECTURE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, cfg.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT,
           cfg.DATASETS.TRAIN) == ("PanopticFPN", SEG_CLASSES, 0.5, (data["train"],)),
          f"{PANOPTIC_CONFIG} as the zoo has it")
    model = predictor.model
    zero_kernel_launches()
    fwd_k.paths = {}
    request_ms = seg_requests(predictor, {"instances", "sem_seg", "panoptic_seg"}, "PanopticFPN")
    check(fwd_k.launches == 4, f"{fwd_k.launches} B1 launches in 2 requests")
    fwd_k.launches = 0
    recorded = []
    fwd = seg_batch_forwards(model, batch, "PanopticFPN", recorded, 2)
    forward_launches, paths = fwd_k.launches, dict(fwd_k.paths)
    check(forward_launches == 2 * (1 + SEG_FORWARDS) and set(paths) == {"vector"}, (forward_launches, paths))
    out = fwd.pop("out")
    check(out["pred_boxes"].shape == (B, cfg.TEST.DETECTIONS_PER_IMAGE, 4) and torch.isfinite(out["pred_boxes"]).all())
    check(min(out["valid"].sum(1).tolist()) > 0)
    del out
    pools = compare_pools(recorded, ("box", "mask"), "PanopticFPN")
    del model, predictor, batch
    torch.cuda.empty_cache()

    # (b) DefaultTrainer at the yaml's input
    out_dir = os.path.join(workdir, "panoptic_trainer")
    tcfg, trainer = seg_trainer(train_net, PANOPTIC_CONFIG, data["train"], None, out_dir, SEG_TRAIN_CKPT)  # (c) evaluates
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith(("roi_heads.", "sem_seg_head."))}
    no_attention_launches("PanopticFPN")
    _, steps, train_s, train_peak = train_counted(trainer, recorded, 2)
    check(len(steps) == SEG_TRAIN_ITERS and all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    train_launches = (fwd_k.launches, bwd_k.launches)
    check(set(fwd_k.paths) == {"vector"}, fwd_k.paths)
    check_loss_values(trainer.storage, PANOPTIC_LOSSES, SEG_TRAIN_ITERS)
    moved(trainer.model, before)
    ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".pth"))
    check(ckpts == [f"model_{SEG_TRAIN_CKPT - 1:07d}.pth", f"model_{2 * SEG_TRAIN_CKPT - 1:07d}.pth", "model_final.pth"], ckpts)
    log(f"  {SEG_TRAIN_ITERS} steps in {train_s:.2f} s, checkpoints {ckpts}; every one of the {len(before)} ROI and sem-seg "
        f"head tensors moved")
    stats = step_times(trainer.storage, tcfg.SOLVER.IMS_PER_BATCH, card, train_peak)
    train_fwd, train_bwd = compare_recorded_pools(recorded, "PanopticFPN first-batch")
    del trainer
    torch.cuda.empty_cache()

    # (c) train_net --eval-only of the checkpoint, the three evaluators
    eval_s = {}
    classes = (COCOEvaluator, SemSegEvaluator, COCOPanopticEvaluator)
    saved = {cls: cls.evaluate for cls in classes}
    for cls in classes:
        eval_s[cls.__name__] = []
        cls.evaluate = timing_evaluate(cls, eval_s[cls.__name__])
    args = train_net.argument_parser().parse_args([
        "--config-file", os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", PANOPTIC_CONFIG), "--eval-only",
        "MODEL.WEIGHTS", os.path.join(out_dir, "model_final.pth"), "TPU.COMPUTE_DTYPE", "bfloat16",
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "DATASETS.TEST", f'("{data["val"]}",)',
        "OUTPUT_DIR", os.path.join(workdir, "panoptic_eval"),
    ])
    no_attention_launches("PanopticFPN")
    zero_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = train_net.main(args)
    finally:
        for cls, fn in saved.items():
            cls.evaluate = fn
    torch.cuda.synchronize()
    eval_total_s = time.perf_counter() - t0
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_launches = fwd_k.launches
    check(eval_launches == 2 * SEG_IMAGES and bwd_k.launches == 0, (eval_launches, bwd_k.launches))
    check(list(results) == ["sem_seg", "bbox", "segm", "panoptic_seg"], list(results))
    main_keys = {"sem_seg": ("mIoU", "fwIoU", "mACC", "pACC"), "bbox": EVAL_KEYS[:3], "segm": EVAL_KEYS[:3],
                 "panoptic_seg": ("PQ", "SQ", "RQ", "PQ_th", "PQ_st")}
    for task, keys in main_keys.items():
        values = [results[task][k] for k in keys]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        log(f"  --eval-only {task}: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(keys, values)))
    log(f"  --eval-only over {SEG_IMAGES} images in {eval_total_s:.2f} s (model build and load included), of it evaluate: "
        + ", ".join(f"{k} {v[0]:.2f} s" for k, v in eval_s.items()) + f"; B1 launches {eval_launches}; peak {eval_peak:.2f} GiB")
    torch.cuda.empty_cache()

    # (d) lazyconfig_train_net --eval-only of the .py config, seeded and calibrated weights
    lazy_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", PANOPTIC_LAZY_CONFIG)
    lcfg = LazyConfig.load(lazy_path)
    check(lcfg.dataloader.test.dataset.names == data["val"].replace("_100", ""), lcfg.dataloader.test.dataset.names)
    lazy_model = instantiate(lcfg.model).to(device)
    heads = lazy_model.roi_heads
    check((heads.box_pooler.output_size, heads.box_head.fc_dims, lazy_model.proposal_generator.pre_nms_topk[False])
          == ((14, 14), (), 6000), "the lazy model's get_cfg() box head and RPN")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(lazy_model, gen)
    first = next(iter(instantiate(lcfg.dataloader.test)))
    calibrate_frozen_bn(lazy_model, {k: v for k, v in first.items() if k != "metadata"})
    lazy_dir = os.path.join(workdir, "panoptic_lazy")
    DetectionCheckpointer(lazy_model, lazy_dir).save("seeded")
    del lazy_model
    largs = lazyconfig_train_net.argument_parser().parse_args([
        "--config-file", lazy_path, "--eval-only", f"train.init_checkpoint={os.path.join(lazy_dir, 'seeded.pth')}",
        f"train.output_dir={lazy_dir}",
    ])
    no_attention_launches("PanopticFPN")
    zero_kernel_launches()
    lazy_recorded = []
    kernel_entry = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = recording_entry(poolers, lazy_recorded, 2)
    t0 = time.perf_counter()
    try:
        lazy_results = lazyconfig_train_net.main(largs)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    lazy_s = time.perf_counter() - t0
    lazy_launches = fwd_k.launches
    check(lazy_launches == 2 * SEG_IMAGES, lazy_launches)
    check(list(lazy_results) == ["bbox", "segm", "sem_seg", "panoptic_seg"], list(lazy_results))
    check(all(math.isfinite(lazy_results[t][k]) for t, keys in main_keys.items() for k in keys), lazy_results)
    check(lazy_recorded[0][0][5] == (14, 14), lazy_recorded[0][0][5])
    lazy_pools = compare_pools(lazy_recorded, ("box14", "mask"), "lazy PanopticFPN")
    log(f"  lazyconfig_train_net --eval-only over {SEG_IMAGES} images in {lazy_s:.2f} s: PQ "
        f"{lazy_results['panoptic_seg']['PQ']:.4f}, mIoU {lazy_results['sem_seg']['mIoU']:.4f}, bbox AP "
        f"{lazy_results['bbox']['AP']:.4f}; B1 launches {lazy_launches}")
    torch.cuda.empty_cache()

    no_attention_launches("PanopticFPN")

    # (e) the ground truth fed back
    meta = MetadataCatalog.get(data["val"])
    pan = COCOPanopticEvaluator(data["val"])
    pan.reset()
    with open(meta.panoptic_json) as f:
        anns = json.load(f)["annotations"]
    thing, stuff = meta.thing_dataset_id_to_contiguous_id, meta.stuff_dataset_id_to_contiguous_id
    for ann in anns:
        ids = rgb2id(read_png(os.path.join(meta.panoptic_root, ann["file_name"])))
        info = [{"id": s["id"], "isthing": s["category_id"] in thing,
                 "category_id": thing[s["category_id"]] if s["category_id"] in thing else stuff[s["category_id"]]}
                for s in ann["segments_info"]]
        pan.process({"metadata": [{"image_id": ann["image_id"]}]}, {"panoptic_seg": [(ids.astype(np.int32), info)]})
    pq = pan.evaluate()["panoptic_seg"]
    check(all(pq[k] == 100.0 for k in ("PQ", "SQ", "RQ", "PQ_th", "PQ_st")), pq)
    miou = sem_seg_ground_truth(device, data["val"])
    perfect = COCOEvaluator(data["val"], distributed=False)
    by_image = {}
    for det in ground_truth_detections(meta.json_file):
        det["category_id"] = thing[det["category_id"]]
        by_image.setdefault(det["image_id"], []).append(det)
    perfect._predictions = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    ap = perfect.evaluate()
    check(ap["bbox"]["AP"] == 100.0, ap["bbox"])
    log(f"  ground truth fed back: PQ {pq['PQ']}, mIoU {miou['mIoU']}, pACC {miou['pACC']}, bbox AP {ap['bbox']['AP']}, "
        f"segm AP {ap['segm']['AP']:.4f}")
    return {
        "seg_write_s": data["write_s"],
        "panoptic_request_ms": request_ms,
        **{f"panoptic_{k}": v for k, v in fwd.items()},
        **{f"panoptic_train_{k}": v for k, v in stats.items()},
        "panoptic_train_peak_gib": train_peak,
        "panoptic_eval_s": eval_total_s,
        "panoptic_eval_evaluate_s": {k: v[0] for k, v in eval_s.items()},
        "panoptic_eval_peak_gib": eval_peak,
        **{f"panoptic_eval_{t}_{k}": results[t][k] for t, keys in main_keys.items() for k in keys},
        "panoptic_lazy_eval_s": lazy_s,
        "panoptic_phase_s": time.perf_counter() - t_phase,
        "b1_launches": 4 + forward_launches + train_launches[0] + eval_launches + lazy_launches,
        "b2_launches": train_launches[1],
        "pools": pools,
        "fwd": train_fwd,
        "bwd": train_bwd,
        "lazy_pools": lazy_pools,
    }


def phase_semantic(device, card: str, workdir: str, data: dict):
    """SemanticSegmentor R50-FPN from ``configs/Misc/semantic_R_50_FPN_1x.yaml``
    as it is (54 classes; bf16, seeded weights): DefaultPredictor requests
    and one plus SEG_FORWARDS timed batch forwards at 16 x 800x1344;
    DefaultTrainer SEG_TRAIN_ITERS steps at 16 images from the synthetic
    ``coco_2017_train_panoptic_stuffonly`` at the yaml's input, then its
    EvalHook through ``build_evaluator``'s SemSegEvaluator on
    ``coco_2017_val_100_panoptic_stuffonly``; the stuff labels fed back at
    mIoU 100. None of B1-B4 launches on this path."""
    import torch

    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.evaluation import SemSegEvaluator
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    zero_kernel_launches()
    cfg, predictor, batch = seeded_zoo_model(device, SEMANTIC_CONFIG)
    check((cfg.MODEL.META_ARCHITECTURE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, cfg.DATASETS.TRAIN)
          == ("SemanticSegmentor", SEG_CLASSES, (data["stuff_train"],)), f"{SEMANTIC_CONFIG} as the zoo has it")
    request_ms = seg_requests(predictor, {"sem_seg"}, "SemanticSegmentor")
    fwd = seg_batch_forwards(predictor.model, batch, "SemanticSegmentor")
    del fwd["out"], predictor, batch
    torch.cuda.empty_cache()

    cfg, trainer = seg_trainer(train_net, SEMANTIC_CONFIG, data["stuff_train"], data["stuff_val"],
                               os.path.join(workdir, "semantic_trainer"), 10 * SEG_TRAIN_ITERS)
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("sem_seg_head.")}
    steps, eval_s = [], []
    trainer.register_hooks([hooks.CallbackHook(after_step=lambda t: steps.append(t.iter))])
    evaluate = SemSegEvaluator.evaluate
    SemSegEvaluator.evaluate = timing_evaluate(SemSegEvaluator, eval_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = trainer.train()
    finally:
        SemSegEvaluator.evaluate = evaluate
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(steps) == SEG_TRAIN_ITERS, steps)
    check_loss_values(trainer.storage, ("total_loss",), SEG_TRAIN_ITERS)  # loss_sem_seg, the only loss
    moved(trainer.model, before)
    check(list(results) == ["sem_seg"] and len(eval_s) == 1, (list(results), eval_s))
    keys = ("mIoU", "fwIoU", "mACC", "pACC")
    check(all(math.isfinite(results["sem_seg"][k]) and 0 <= results["sem_seg"][k] <= 100 for k in keys), results["sem_seg"])
    log(f"  {SEG_TRAIN_ITERS} steps + SemSegEvaluator over {SEG_IMAGES} images in {train_s:.2f} s (evaluate "
        f"{eval_s[0]:.2f} s): " + ", ".join(f"{k} {results['sem_seg'][k]:.4f}" for k in keys))
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, train_peak)
    del trainer
    torch.cuda.empty_cache()
    miou = sem_seg_ground_truth(device, data["stuff_val"])
    log(f"  stuff labels fed back: mIoU {miou['mIoU']}, pACC {miou['pACC']}")
    counts = no_kernel_launches("SemanticSegmentor")
    return {
        "semantic_request_ms": request_ms,
        **{f"semantic_{k}": v for k, v in fwd.items()},
        **{f"semantic_train_{k}": v for k, v in stats.items()},
        "semantic_train_peak_gib": train_peak,
        **{f"semantic_eval_{k}": results["sem_seg"][k] for k in keys},
        "semantic_phase_s": time.perf_counter() - t_phase,
        "semantic_kernel_launches": counts,
    }


SEG_PHASES = (
    (32, "PanopticFPN R50-FPN: batch forward, DefaultTrainer, --eval-only with its three evaluators, the lazy config",
     phase_panoptic),
    (33, "SemanticSegmentor R50-FPN: batch forward, DefaultTrainer and SemSegEvaluator", phase_semantic),
)


def run_seg_phases(timed, device, card: str, workdir: str) -> dict:
    """Phases 32-33 on one synthetic COCO panoptic tree."""
    import torch

    data = seg_data()
    out = {}
    for n, title, fn in SEG_PHASES:
        out[n] = timed(n, title, fn, device, card, workdir, data)
        torch.cuda.empty_cache()
    return out


# phases 34-35: the R-CNN options (Fast R-CNN, GIoU, TRAIN_ON_PRED_BOXES) and Cityscapes
FAST_RCNN_CONFIG = "COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml"
GIOU_CONFIG = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x_giou.yaml"
PRED_BOXES_CONFIG = "quick_schedules/mask_rcnn_R_50_FPN_pred_boxes_training_acc_test.yaml"
CITYSCAPES_CONFIG = "Cityscapes/mask_rcnn_R_50_FPN.yaml"
# 32 synthetic COCO images of 480x800, 800x1333 after the test resize (the
# main path's 16 x 800x1344 batch); the first 16 are the val set
RCNN_IMAGES, RCNN_VAL_IMAGES, RCNN_IMAGE_SIZE = 32, 16, (480, 800)
RCNN_FORWARDS = 2  # timed batch forwards after the recorded one
# 4 steps and 8 + 2 Cityscapes images, not 10 and 16 + 8: 6 steps and 8 + 4
# images from phases 36-38 (as phase 11), these from 39-40
RCNN_TRAIN_ITERS, PRED_BOXES_ITERS = 4, 3
CITYSCAPES_TRAIN_IMAGES, CITYSCAPES_VAL_IMAGES = 8, 2
CITYSCAPES_ITERS, CITYSCAPES_CKPT = 4, 2
CITYSCAPES_MIN_SIZES = (800, 832, 864, 896, 928, 960, 992, 1024)
FAST_RCNN_LOSSES = ("loss_cls", "loss_box_reg")


def rcnn_options_data(workdir: str) -> dict:
    """The synthetic COCO images (``testing.write_synthetic_coco``, one size)
    registered as a train set and its first RCNN_VAL_IMAGES as a val set,
    and a d2 proposal file over them (``testing.write_synthetic_proposals``:
    2000 boxes an image, the train top-k); returns the names, the file and
    the seconds."""
    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.testing import write_synthetic_coco, write_synthetic_proposals

    t0 = time.perf_counter()
    json_file, image_root = write_synthetic_coco(os.path.join(workdir, "rcnn_options"), RCNN_IMAGES, seed=5,
                                                 sizes=(RCNN_IMAGE_SIZE,))
    names = {"train": "chip_smoke_rcnn_train", "val": "chip_smoke_rcnn_val16"}
    register_coco_instances(names["train"], {}, json_file, image_root)
    register_coco_instances(names["val"], {}, first_images(json_file, RCNN_VAL_IMAGES, os.path.join(workdir, "rcnn_val16.json")),
                            image_root)
    proposals = write_synthetic_proposals(os.path.join(workdir, "rcnn_options"), DatasetCatalog.get(names["train"]), 2000, seed=5)
    return {**names, "proposals": proposals, "write_s": time.perf_counter() - t0}


def to_device(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items() if k != "metadata"}


def giou_plain(boxes1, boxes2) -> np.ndarray:
    """The GIoU loss of XYXY boxes in float64 numpy, written from its
    definition: 1 - IoU + (enclosing area - union) / enclosing area, 1e-7
    added to the union and to the enclosing area."""
    a, b = boxes1.double().cpu().numpy(), boxes2.double().cpu().numpy()
    iw = np.clip(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), 0, None)
    inter = iw * ih
    union = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
    enclosing = (np.maximum(a[:, 2], b[:, 2]) - np.minimum(a[:, 0], b[:, 0])) * (
        np.maximum(a[:, 3], b[:, 3]) - np.minimum(a[:, 1], b[:, 1]))
    return 1 - inter / (union + 1e-7) + (enclosing - union) / (enclosing + 1e-7)


def rcnn_trainer(train_net, cfg, calib_name: str):
    """``tools/train_net.py``'s Trainer of ``cfg`` with seeded weights, its
    FrozenBN statistics calibrated on 4 images of ``calib_name``."""
    trainer = yaml_trainer(train_net)(cfg)
    trainer.resume_or_load(resume=False)
    calibrate_on_train_images(trainer.model, cfg, calib_name)
    return trainer


def train_counted(trainer, recorded, n_pools: int, evaluator=None, eval_s=None):
    """``trainer.train()`` with every count at 0 before it, B1/B2's counts
    read after every step, the first step's ``n_pools`` pools recorded and
    ``evaluator.evaluate``'s seconds appended to ``eval_s``; returns
    (result, per-step launches, seconds, peak GiB)."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda

    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    per_step = []
    trainer.register_hooks([hooks.CallbackHook(after_step=lambda t: per_step.append((fwd_k.launches, bwd_k.launches)))])
    patches = [(poolers, "roi_align_multilevel", lambda _: recording_pools(poolers, recorded, n_pools))] if n_pools else []
    if evaluator is not None:
        patches.append((evaluator, "evaluate", lambda _: timing_evaluate(evaluator, eval_s)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    fwd_k.paths = {}
    t0 = time.perf_counter()
    with _Patched(patches):
        result = trainer.train()
    torch.cuda.synchronize()
    check(set(fwd_k.paths) <= {"vector"}, fwd_k.paths)
    return result, step_launches(per_step), time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def phase_rcnn_options(device, card: str, workdir: str):
    """The R-CNN options of three zoo yamls as they are (bf16, seeded
    weights, phase 11's cuts): (a) Fast R-CNN, ``fast_rcnn_R_50_FPN_1x.yaml``
    (``PrecomputedProposals``), with ``DATASETS.PROPOSAL_FILES_*`` set to a
    synthetic d2 proposal file: one recorded and RCNN_FORWARDS timed
    forwards of the test loader's 16 x 800x1344 batch with 1000 proposals an
    image, B1 once a forward (the box pool) held on it; RCNN_TRAIN_ITERS
    DefaultTrainer steps at the yaml's input (16 images, 2000 proposals an
    image from the train loader), B1 and B2 once a step, held on the first
    batch's pool and cotangent, then COCOEvaluator bbox over the 16 val
    images; no proposal generator and no RPN loss; (b)
    ``mask_rcnn_R_50_FPN_1x_giou.yaml``: RCNN_TRAIN_ITERS steps with the
    RPN's GIoU loss at weight 2 and the box head's at 10, the first step's
    two GIoU calls held against the loss written in float64, B1 and B2
    twice a step, held on the first batch; (c) the pred-boxes quick-schedule
    yaml (its own 600 / 1000 input): PRED_BOXES_ITERS steps with
    ``TRAIN_ON_PRED_BOXES``, which the JAX package reads nowhere (the CPU
    tests hold the losses with and without it equal), B1 and B2 twice a
    step."""
    import torch

    import detectron2_tpu_torch.layers.losses as losses
    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    data = rcnn_options_data(workdir)
    log(f"  synthetic COCO: {RCNN_IMAGES} images of {RCNN_IMAGE_SIZE[0]}x{RCNN_IMAGE_SIZE[1]}, the first {RCNN_VAL_IMAGES} "
        f"the val set, and a proposal file of 2000 boxes an image, written in {data['write_s']:.2f} s")

    # (a) Fast R-CNN: the batch forward
    cfg = model_zoo.get_config(FAST_RCNN_CONFIG)
    check((cfg.MODEL.LOAD_PROPOSALS, cfg.MODEL.PROPOSAL_GENERATOR.NAME, cfg.MODEL.MASK_ON,
           cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN, cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
          == (True, "PrecomputedProposals", False, 2000, 1000), f"{FAST_RCNN_CONFIG} as the zoo has it")
    check(all(f.startswith("detectron2://") for f in cfg.DATASETS.PROPOSAL_FILES_TRAIN + cfg.DATASETS.PROPOSAL_FILES_TEST),
          "the yaml's proposal files are downloads")
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.DATASETS.TEST, cfg.DATASETS.PROPOSAL_FILES_TEST = (data["val"],), (data["proposals"],)
    model = build_model(cfg, device=device)
    check(model.proposal_generator is None, type(model.proposal_generator))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    t0 = time.perf_counter()
    batch = next(iter(build_detection_test_loader(cfg, data["val"], batch_size=B)))
    load_s = time.perf_counter() - t0
    check(tuple(batch["image"].shape) == (B, H, W, 3) and tuple(batch["proposal_boxes"].shape) == (B, 1000, 4),
          (tuple(batch["image"].shape), tuple(batch["proposal_boxes"].shape)))
    valid = batch["proposal_valid"]
    log(f"  the test loader's batch of {B} in {load_s:.2f} s: {tuple(batch['image'].shape)}, proposals "
        f"{tuple(batch['proposal_boxes'].shape)}, {int(valid.sum())} valid ({int(valid.sum(1).min())}-{int(valid.sum(1).max())} "
        f"an image)")
    batch = to_device(batch, device)
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    no_attention_launches("Fast R-CNN")
    zero_kernel_launches()
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            poolers.roi_align_multilevel = kernel_entry
            times = []
            for _ in range(RCNN_FORWARDS):
                t0 = time.perf_counter()
                out = model(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    peak = torch.cuda.max_memory_allocated() / 2**30
    forward_launches = fwd_k.launches
    check(forward_launches == 1 + RCNN_FORWARDS and bwd_k.launches == 0, (forward_launches, bwd_k.launches))
    check(out["pred_boxes"].shape == (B, cfg.TEST.DETECTIONS_PER_IMAGE, 4) and torch.isfinite(out["pred_boxes"]).all())
    check(min(out["valid"].sum(1).tolist()) > 0 and "pred_masks" not in out, sorted(out))
    batch_ms = float(np.median(times))
    log(f"  Fast R-CNN batch forward {B}x{H}x{W}, 1000 proposals an image: first {first_ms:.1f} ms, then median "
        f"{batch_ms:.1f} ms/batch ({B / batch_ms * 1e3:.2f} img/s) over {RCNN_FORWARDS}; peak memory {peak:.2f} GiB; "
        f"B1 launches {forward_launches}, one a forward")
    pools = compare_pools(recorded, ("box",), "Fast R-CNN")
    del model, batch, out
    torch.cuda.empty_cache()

    # (a) Fast R-CNN: DefaultTrainer, then COCOEvaluator on the val set
    tcfg = zoo_train_config(FAST_RCNN_CONFIG, data["train"], data["val"], os.path.join(workdir, "fast_rcnn"), RCNN_TRAIN_ITERS)
    tcfg.MODEL.WEIGHTS = ""
    tcfg.DATASETS.PROPOSAL_FILES_TRAIN = tcfg.DATASETS.PROPOSAL_FILES_TEST = (data["proposals"],)
    trainer = rcnn_trainer(train_net, tcfg, data["val"])
    check(trainer.model.proposal_generator is None, "Fast R-CNN builds no proposal generator")
    results, steps, train_s, train_peak = train_counted(trainer, recorded, 1)
    check(len(steps) == RCNN_TRAIN_ITERS and all(s == (1, 1) for s in steps), f"per-step (forward, backward) launches {steps}")
    fast_train = (fwd_k.launches, bwd_k.launches)
    check(fast_train == (RCNN_TRAIN_ITERS + RCNN_VAL_IMAGES, RCNN_TRAIN_ITERS), f"B1, B2 launches {fast_train}")
    check(not any(k.startswith("loss_rpn") for k in trainer.storage.histories()), "an RPN loss without an RPN")
    check_loss_values(trainer.storage, FAST_RCNN_LOSSES, RCNN_TRAIN_ITERS)
    check(list(results) == ["bbox"] and all(math.isfinite(results["bbox"][k]) for k in EVAL_KEYS[:3]), results)
    log(f"  {RCNN_TRAIN_ITERS} steps at {tcfg.SOLVER.IMS_PER_BATCH} images with 2000 proposals an image, then COCOEvaluator "
        f"over {RCNN_VAL_IMAGES} "
        f"images, in {train_s:.2f} s: bbox " + ", ".join(f"{k} {results['bbox'][k]:.4f}" for k in EVAL_KEYS[:3]))
    fast_stats = step_times(trainer.storage, tcfg.SOLVER.IMS_PER_BATCH, card, train_peak)
    fast_fwd, fast_bwd = compare_recorded_pools(recorded, "Fast R-CNN first-batch", keys=(BOX_RES,))
    del trainer
    torch.cuda.empty_cache()

    # (b) the GIoU yaml: the RPN's and the box head's GIoU losses
    gcfg = zoo_train_config(GIOU_CONFIG, data["train"], data["val"], os.path.join(workdir, "giou"), RCNN_TRAIN_ITERS)
    check((gcfg.MODEL.RPN.BBOX_REG_LOSS_TYPE, gcfg.MODEL.RPN.BBOX_REG_LOSS_WEIGHT, gcfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
           gcfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT) == ("giou", 2.0, "giou", 10.0), f"{GIOU_CONFIG} as the zoo has it")
    gcfg.MODEL.WEIGHTS = ""
    gcfg.DATASETS.TEST = ()
    trainer = rcnn_trainer(train_net, gcfg, data["val"])
    calls = []
    giou = losses.IOU_LOSSES["giou"]

    def recording_giou(boxes1, boxes2, reduction="none"):
        out = giou(boxes1, boxes2, reduction)
        if len(calls) < 2:  # the first step's: the RPN's, then the box head's
            calls.append((boxes1.detach().clone(), boxes2.detach().clone(), out.detach().clone()))
        return out

    losses.IOU_LOSSES["giou"] = recording_giou
    try:
        _, steps, _, giou_peak = train_counted(trainer, recorded, 2)
    finally:
        losses.IOU_LOSSES["giou"] = giou
    check(len(steps) == RCNN_TRAIN_ITERS and all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    giou_launches = (fwd_k.launches, bwd_k.launches)
    check_loss_values(trainer.storage, LOSSES, RCNN_TRAIN_ITERS)
    check(len(calls) == 2, len(calls))
    giou_err = {}
    ims = gcfg.SOLVER.IMS_PER_BATCH
    for (boxes1, boxes2, out), name, n in zip(calls, ("rpn", "box_head"), (ims * gcfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
                                                                            ims * gcfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE)):
        ref = giou_plain(boxes1.reshape(-1, 4), boxes2.reshape(-1, 4))
        got = out.reshape(-1).double().cpu().numpy()
        check(got.shape == ref.shape == (n,) and np.isfinite(got).all(), (name, got.shape, n))
        err = np.abs(got - ref)
        check((err <= 1e-5 + 1e-5 * np.abs(ref)).all(), f"{name} GIoU: max |float32 - float64 formula| {err.max():.3e}")
        giou_err[name] = float(err.max())
        log(f"  first step's {name} GIoU loss over {n} boxes (float32) vs its float64 formula: max abs err {err.max():.3e} "
            f"(tol 1e-5 + 1e-5*|ref|), mean loss {ref.mean():.4f}")
    giou_stats = step_times(trainer.storage, gcfg.SOLVER.IMS_PER_BATCH, card, giou_peak)
    giou_fwd, giou_bwd = compare_recorded_pools(recorded, "GIoU first-batch")
    del trainer
    torch.cuda.empty_cache()

    # (c) TRAIN_ON_PRED_BOXES: read nowhere, as in the JAX package
    pcfg = zoo_train_config(PRED_BOXES_CONFIG, data["train"], data["val"], os.path.join(workdir, "pred_boxes"),
                            PRED_BOXES_ITERS, min_sizes=(600,), max_size=1000)
    check(pcfg.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES and pcfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE == 256,
          f"{PRED_BOXES_CONFIG} as the zoo has it")
    pcfg.MODEL.WEIGHTS = ""
    pcfg.DATASETS.TEST = ()
    pcfg.TEST.EXPECTED_RESULTS = []  # the AP of 6000 steps from ImageNet weights
    trainer = rcnn_trainer(train_net, pcfg, data["val"])
    check(trainer.model.roi_heads.train_on_pred_boxes, "the flag reaches StandardROIHeads")
    _, steps, _, _ = train_counted(trainer, recorded, 0)
    check(len(steps) == PRED_BOXES_ITERS and all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    pred_launches = (fwd_k.launches, bwd_k.launches)
    check_loss_values(trainer.storage, LOSSES, PRED_BOXES_ITERS)
    log(f"  TRAIN_ON_PRED_BOXES: {PRED_BOXES_ITERS} steps at {pcfg.SOLVER.IMS_PER_BATCH} images, B1 and B2 twice a step")
    del trainer
    torch.cuda.empty_cache()
    no_attention_launches("the R-CNN options")
    return {
        "rcnn_options_write_s": data["write_s"],
        "fast_rcnn_batch_first_ms": first_ms,
        "fast_rcnn_batch_ms": batch_ms,
        "fast_rcnn_img_s": B / batch_ms * 1e3,
        "fast_rcnn_peak_gib": peak,
        **{f"fast_rcnn_train_{k}": v for k, v in fast_stats.items()},
        "fast_rcnn_train_peak_gib": train_peak,
        **{f"fast_rcnn_eval_{k}": results["bbox"][k] for k in EVAL_KEYS[:3]},
        **{f"giou_train_{k}": v for k, v in giou_stats.items()},
        "giou_train_peak_gib": giou_peak,
        "giou_formula_max_abs_err": giou_err,
        "rcnn_options_phase_s": time.perf_counter() - t_phase,
        "b1_launches": forward_launches + fast_train[0] + giou_launches[0] + pred_launches[0],
        "b2_launches": fast_train[1] + giou_launches[1] + pred_launches[1],
        "launches": {"fast_rcnn": (forward_launches + fast_train[0], fast_train[1]), "giou": giou_launches,
                     "pred_boxes": pred_launches},
        "pools": pools,
        "fwd": fast_fwd,
        "bwd": fast_bwd,
        "giou_fwd": giou_fwd,
        "giou_bwd": giou_bwd,
    }


def cityscapes_data() -> dict:
    """The synthetic Cityscapes tree (``testing.write_synthetic_cityscapes``
    at 1024 x 2048) under the run's ``$DETECTRON2_DATASETS``, where the
    builtin ``cityscapes_fine_*`` names point."""
    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.testing import write_synthetic_cityscapes

    t0 = time.perf_counter()
    write_synthetic_cityscapes(os.environ["DETECTRON2_DATASETS"], CITYSCAPES_TRAIN_IMAGES, seed=0, n_val=CITYSCAPES_VAL_IMAGES)
    names = {"train": "cityscapes_fine_instance_seg_train", "val": "cityscapes_fine_instance_seg_val",
             "sem_val": "cityscapes_fine_sem_seg_val"}
    sizes = {k: len(DatasetCatalog.get(n)) for k, n in names.items()}
    check(sizes == {"train": CITYSCAPES_TRAIN_IMAGES, "val": CITYSCAPES_VAL_IMAGES, "sem_val": CITYSCAPES_VAL_IMAGES}, sizes)
    return {**names, "write_s": time.perf_counter() - t0}


def phase_cityscapes(device, card: str, workdir: str):
    """``Cityscapes/mask_rcnn_R_50_FPN.yaml`` as it is (8 classes, 8 images
    a step at 800-1024 / 2048; bf16, seeded weights, phase 11's cuts) on a
    synthetic Cityscapes of CITYSCAPES_TRAIN_IMAGES train and
    CITYSCAPES_VAL_IMAGES val images of 1024 x 2048 under the builtin names:
    CITYSCAPES_ITERS DefaultTrainer steps, a checkpoint every
    CITYSCAPES_CKPT, B1 and B2 twice a step, held on the first batch's pools
    and cotangents in bf16 and float32 and timed beside their bound (the
    first B1/B2 times at p2 up to 256 x 512); ``train_net --eval-only`` of
    the step-3 checkpoint through CityscapesInstanceEvaluator (segm AP,
    AP50); CityscapesSemSegEvaluator over the val images on constant
    predictions, and on the labels fed back (IoU 100)."""
    import torch

    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
    from detectron2_tpu_torch.evaluation.cityscapes_evaluation import CITYSCAPES_ID_TO_TRAINID
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = roi_align_multilevel_cuda, roi_align_multilevel_backward_cuda
    data = cityscapes_data()
    log(f"  synthetic Cityscapes: {CITYSCAPES_TRAIN_IMAGES} train and {CITYSCAPES_VAL_IMAGES} val images of 1024x2048 "
        f"under $DETECTRON2_DATASETS (the builtin names), written in {data['write_s']:.2f} s")
    out_dir = os.path.join(workdir, "cityscapes")
    cfg = zoo_train_config(CITYSCAPES_CONFIG, data["train"], data["val"], out_dir, CITYSCAPES_ITERS,
                           min_sizes=CITYSCAPES_MIN_SIZES, max_size=2048, ims_per_batch=8)
    check((cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, cfg.DATASETS.TRAIN)
          == (8, 1024, 2048, (data["train"],)), f"{CITYSCAPES_CONFIG} as the zoo has it")
    cfg.MODEL.WEIGHTS = ""
    cfg.DATASETS.TEST = ()  # --eval-only evaluates
    cfg.SOLVER.CHECKPOINT_PERIOD = CITYSCAPES_CKPT
    trainer = rcnn_trainer(train_net, cfg, data["train"])
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("roi_heads.")}
    recorded = []
    _, steps, train_s, train_peak = train_counted(trainer, recorded, 2)
    check(len(steps) == CITYSCAPES_ITERS and all(s == (2, 2) for s in steps), f"per-step (forward, backward) launches {steps}")
    train_launches = (fwd_k.launches, bwd_k.launches)
    check_loss_values(trainer.storage, LOSSES, CITYSCAPES_ITERS)
    moved(trainer.model, before)
    ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".pth"))
    check(ckpts == [f"model_{CITYSCAPES_CKPT - 1:07d}.pth", f"model_{2 * CITYSCAPES_CKPT - 1:07d}.pth", "model_final.pth"], ckpts)
    log(f"  {CITYSCAPES_ITERS} steps in {train_s:.2f} s, checkpoints {ckpts}")
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, train_peak)
    levels = [tuple(f.shape[1:3]) for f in recorded[0]["args"][0]]
    fwd, bwd = compare_recorded_pools(recorded, "Cityscapes first-batch")
    log(f"  B1/B2 at the Cityscapes shapes (levels {levels}): B1 box {fwd[BOX_RES]['ms']:.4f} ms (bound "
        f"{fwd[BOX_RES]['bound_ms']:.4f}, plain {fwd[BOX_RES]['plain_ms']:.3f}), mask {fwd[MASK_RES]['ms']:.4f} ms (bound "
        f"{fwd[MASK_RES]['bound_ms']:.4f}, plain {fwd[MASK_RES]['plain_ms']:.3f}); B2 box {bwd[BOX_RES]['ms']:.4f} ms (bound "
        f"{bwd[BOX_RES]['bound_ms']:.4f}, plain {bwd[BOX_RES]['plain_ms']:.3f}), mask {bwd[MASK_RES]['ms']:.4f} ms (bound "
        f"{bwd[MASK_RES]['bound_ms']:.4f}, plain {bwd[MASK_RES]['plain_ms']:.3f}); {card}")
    del trainer
    torch.cuda.empty_cache()

    # train_net --eval-only of the checkpoint at CITYSCAPES_CKPT, CityscapesInstanceEvaluator
    eval_s = []
    evaluate = CityscapesInstanceEvaluator.evaluate
    CityscapesInstanceEvaluator.evaluate = timing_evaluate(CityscapesInstanceEvaluator, eval_s)
    args = train_net.argument_parser().parse_args([
        "--config-file", os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", CITYSCAPES_CONFIG), "--eval-only",
        "MODEL.WEIGHTS", os.path.join(out_dir, f"model_{CITYSCAPES_CKPT - 1:07d}.pth"), "TPU.COMPUTE_DTYPE", "bfloat16",
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "OUTPUT_DIR", os.path.join(workdir, "cityscapes_eval"),
    ])
    no_attention_launches("Cityscapes")
    zero_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = train_net.main(args)
    finally:
        CityscapesInstanceEvaluator.evaluate = evaluate
    torch.cuda.synchronize()
    eval_total_s = time.perf_counter() - t0
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_launches = fwd_k.launches
    check(eval_launches == 2 * CITYSCAPES_VAL_IMAGES and bwd_k.launches == 0, (eval_launches, bwd_k.launches))
    check(list(results) == ["segm"] and list(results["segm"]) == ["AP", "AP50"], results)
    check(all(math.isfinite(v) and 0 <= v <= 100 for v in results["segm"].values()), results)
    log(f"  --eval-only over {CITYSCAPES_VAL_IMAGES} images in {eval_total_s:.2f} s (model build and load included; "
        f"CityscapesInstanceEvaluator.evaluate {eval_s[0]:.2f} s): segm AP {results['segm']['AP']:.4f}, AP50 "
        f"{results['segm']['AP50']:.4f}; B1 launches {eval_launches}; peak {eval_peak:.2f} GiB")

    # CityscapesSemSegEvaluator: constant predictions, then the labels fed back
    to_train = np.full(256, 255, np.int64)
    for label_id, train_id in CITYSCAPES_ID_TO_TRAINID.items():
        to_train[label_id] = train_id
    sem = {}
    for name in ("constant", "fed_back"):
        ev = CityscapesSemSegEvaluator(data["sem_val"])
        ev.reset()
        for d in DatasetCatalog.get(data["sem_val"]):
            ids = read_image(ev._gt_file({"file_name": d["file_name"]}), "L")[..., 0]  # the file it reads
            h, w = ids.shape
            if name == "constant":
                logits = torch.zeros((1, h, w, 19), device=device)
                logits[..., 0] = 1.0  # road everywhere
            else:
                lab = torch.as_tensor(to_train[ids], device=device)
                logits = torch.nn.functional.one_hot(torch.where(lab == 255, 0, lab), 19).float()[None]
            ev.process({"image_sizes": torch.tensor([[h, w]]), "metadata": [{"file_name": d["file_name"]}]},
                       {"sem_seg": logits})
        sem[name] = ev.evaluate()["sem_seg"]["IoU"]
    check(math.isfinite(sem["constant"]) and 0 < sem["constant"] < 100, sem)
    check(sem["fed_back"] == 100.0, sem)
    log(f"  CityscapesSemSegEvaluator over {CITYSCAPES_VAL_IMAGES} images: IoU {sem['constant']:.4f} for road everywhere, "
        f"{sem['fed_back']} for the labels fed back")
    no_attention_launches("Cityscapes")
    return {
        "cityscapes_write_s": data["write_s"],
        **{f"cityscapes_train_{k}": v for k, v in stats.items()},
        "cityscapes_train_peak_gib": train_peak,
        "cityscapes_levels": levels,
        "cityscapes_eval_s": eval_total_s,
        "cityscapes_eval_peak_gib": eval_peak,
        **{f"cityscapes_eval_segm_{k}": v for k, v in results["segm"].items()},
        "cityscapes_sem_seg_iou": sem,
        "cityscapes_phase_s": time.perf_counter() - t_phase,
        "b1_launches": train_launches[0] + eval_launches,
        "b2_launches": train_launches[1],
        "fwd": fwd,
        "bwd": bwd,
    }


RCNN_OPTIONS_PHASES = (
    (34, "the R-CNN options: Fast R-CNN with proposal files, the GIoU yaml, TRAIN_ON_PRED_BOXES", phase_rcnn_options),
    (35, "Cityscapes Mask R-CNN R50-FPN: DefaultTrainer at 1024x2048, --eval-only, the Cityscapes evaluators",
     phase_cityscapes),
)


def run_rcnn_options_phases(timed, device, card: str, workdir: str) -> dict:
    import torch

    out = {}
    for n, title, fn in RCNN_OPTIONS_PHASES:
        with attention_free(f"phase {n}"):
            out[n] = timed(n, title, fn, device, card, workdir)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phases 36-38
# the hierarchical backbones, lazy zoo configs as they are: MViTv2 and Swin
# (their attention plain PyTorch, as the JAX package computes it: none of
# B3/B4), RegNetX (FrozenBN, SGD) and RegNetY (SE, SyncBN), each under an FPN
MVIT_B_CONFIG = "ViTDet/cascade_mask_rcnn_mvitv2_b_in21k_100ep.py"
MVIT_T_CONFIG = "MViTv2/mask_rcnn_mvitv2_t_3x.py"
SWIN_B_CONFIG = "ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py"
REGNETX_CONFIG = "COCO-InstanceSegmentation/mask_rcnn_regnetx_4gf_dds_fpn_1x.py"
REGNETY_CONFIG = "new_baselines/mask_rcnn_regnety_4gf_dds_FPN_100ep_LSJ.py"
BACKBONE_REQUESTS = ((480, 640), (427, 1000))
BACKBONE_FORWARDS = 2  # timed batch forwards after the recorded one
# the smoke run's cuts (PERF.md section 4): 3 steps (5 until phases 39-40)
# at 8 images (16 for RegNetX, its own), the evaluation
# after training over 2 images at score threshold 0
BACKBONE_ITERS, REGNETY_ITERS, BACKBONE_TEST_IMAGES = 3, 3, 2
REGNETX_TRAIN_BATCH, REGNETY_TRAIN_BATCH = 16, 8
CASCADE_POOLS = ("box stage 1", "box stage 2", "box stage 3", "mask")
MASK_RCNN_POOLS = ("box", "mask")
BACKBONE_NAMES = {36: "mvit", 37: "swin", 38: "regnet"}
BACKBONE_KEYS = ("mvit_", "swin_", "regnet")
# what one entry of each path's pools holds, for the kernels line
BACKBONE_PER = {
    "mvit_b": "3 stage box pools + mask pool of one 8x1024x1024 cascade MViTv2-B forward",
    "mvit_t": "box pool + mask pool of one 16x800x1344 MViTv2-T forward (a padded 200x336 first stage)",
    "swin_b": "3 stage box pools + mask pool of one 8x1024x1024 cascade Swin-B forward",
    "regnetx": "box pool + mask pool of one 16x800x1344 RegNetX-4GF forward",
    "mvit_b_train": "3 stage box pools + mask pool of the cascade MViTv2-B run's first 8x1024x1024 batch",
    "swin_b_train": "3 stage box pools + mask pool of the cascade Swin-B run's first 8x1024x1024 batch",
    "regnetx_train": "box pool + mask pool of the RegNetX-4GF run's first 16-image batch",
    "regnety_train": "box pool + mask pool of the RegNetY-4GF LSJ run's first 8x1024x1024 batch",
}


def free_card() -> float:
    """What the phase left to Python's collector, and the cache, back to
    the card; logs the GiB still allocated before the collection (what
    reference cycles held: ~0 since the trainers hold none) and after it.
    Returns the GiB the collection freed."""
    import gc

    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    after = torch.cuda.memory_allocated() / 2**30
    torch.cuda.empty_cache()
    log(f"  card memory allocated: {before:.2f} GiB before gc.collect(), {after:.2f} GiB after")
    return before - after


def score_threshold_zero(model) -> None:
    """Every box predictor's ``test_score_thresh`` at 0 (a cascade has one a
    stage), so that each image keeps ``test_topk_per_image`` detections and
    the mask pool runs at full width."""
    from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers

    predictors = [m for m in model.roi_heads.modules() if isinstance(m, FastRCNNOutputLayers)]
    check(predictors, "no box predictor")
    for p in predictors:
        p.test_score_thresh = 0.0


def lazy_zoo_model(device, config: str):
    """``lazyconfig_train_net.build_model`` of the repo's ``config`` (on the
    card, weights seeded by ``train.seed``) at score threshold 0."""
    from detectron2_tpu_torch.config import LazyConfig
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    model = tool.build_model(LazyConfig.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", config)))
    score_threshold_zero(model)
    check(model.device.type == device.type and str(model.compute_dtype) == "torch.bfloat16", (model.device, model.compute_dtype))
    return model


def noise_batch(device, b: int, h: int, w: int, seed: int) -> dict:
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    images = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device, dtype=torch.uint8)
    return {"image": images, "image_sizes": torch.tensor([[h, w]] * b, dtype=torch.int32, device=device)}


def backbone_inference(model, label: str, batch: dict, test_size, pools, requests: bool = True) -> dict:
    """(a) BACKBONE_REQUESTS through ``DefaultPredictor`` at the config's
    test resize ``test_size`` (min, max), each request's instances checked;
    (b) one recorded and BACKBONE_FORWARDS timed forwards of ``batch``. B1
    launches once a pool (``pools``) a forward, B2-B4 never; B1 is held to
    its plain version on the recorded pools."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import DefaultPredictor

    fwd_k = kernel_counters()["B1"]
    out = {}
    zero_kernel_launches()
    if requests:
        predictor = DefaultPredictor(model=model, min_size_test=test_size[0], max_size_test=test_size[1])
        rng = np.random.RandomState(36)
        ms = []
        for h, w in BACKBONE_REQUESTS:
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            t0 = time.perf_counter()
            inst = predictor(img)["instances"]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(len(inst) > 0, f"{label}: no detections")
            check_instances(inst, len(inst), h, w)
        check(fwd_k.launches == len(pools) * len(BACKBONE_REQUESTS), f"{label}: B1 launches over the requests {fwd_k.launches}")
        out["request_ms"] = ms
        log(f"  {label}: {len(ms)} requests " + ", ".join(f"{h}x{w} {m:.1f} ms" for (h, w), m in zip(BACKBONE_REQUESTS, ms))
            + f"; B1 launches {fwd_k.launches}")
    request_launches = fwd_k.launches
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, len(pools))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            det = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            poolers.roi_align_multilevel = kernel_entry
            times = []
            for _ in range(BACKBONE_FORWARDS):
                t0 = time.perf_counter()
                det = model(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {name: k.launches for name, k in kernel_counters().items()}
    check(counts == {"B1": len(pools) * (1 + BACKBONE_FORWARDS), "B2": 0, "B3": 0, "B4": 0}, f"{label}: launches {counts}")
    n, (bh, bw) = batch["image"].shape[0], batch["image"].shape[1:3]
    D = det["pred_boxes"].shape[1]
    check(det["pred_boxes"].shape == (n, D, 4) and torch.isfinite(det["pred_boxes"]).all(), det["pred_boxes"].shape)
    check(torch.isfinite(det["pred_masks"]).all() and det["pred_masks"].shape[:2] == (n, D), det["pred_masks"].shape)
    n_valid = det["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    batch_ms = float(np.median(times))
    log(f"  {label} batch forward {n}x{bh}x{bw}: first {first_ms:.1f} ms, then median {batch_ms:.1f} ms/batch "
        f"({n / batch_ms * 1e3:.2f} img/s) over {BACKBONE_FORWARDS}; peak memory {peak:.2f} GiB; detections per image "
        f"{n_valid}; B1 launches {counts['B1']}, {len(pools)} a forward")
    with torch.inference_mode():
        out["pools"] = compare_pools(recorded, pools, label)
    out.update(batch_ms=batch_ms, first_batch_ms=first_ms, img_s=n / batch_ms * 1e3, peak_gib=peak,
               launches=request_launches + counts["B1"])
    return out


def backbone_train(device, card: str, workdir: str, coco, label: str, config: str, out_name: str, batch: int, iters: int,
                   pools, calibrate: bool = False) -> dict:
    """``lazyconfig_train_net`` of ``config`` as it is (seeded weights;
    with ``calibrate``, its FrozenBN statistics calibrated on two noise
    images first) on the synthetic COCO for ``iters`` steps at ``batch``
    images, then its evaluation over BACKBONE_TEST_IMAGES images at score
    threshold 0. Checks: B1 and B2 once a pool (``pools``) every step, B1
    once a pool an eval image, B3/B4 never; finite losses; at least 90% of
    the backbone's and the ROI heads' parameter tensors moved; a finite AP.
    B1/B2 held to their plain versions on the first step's pools and
    cotangents. Measures: median step and data time (steps 2 to ``iters``
    - 1), the loader's share, peak memory."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool

    train_name, test_name = f"chip_smoke_{out_name}_train", f"chip_smoke_{out_name}_test"
    # train.init_checkpoint cleared: RegNetX's ImageNet .pkl is a download
    args = lazy_train_args(tool, config, out_name, batch, 10 * iters, workdir, coco, train_name, test_name, iters,
                           extra=["train.init_checkpoint="], test_images=BACKBONE_TEST_IMAGES)
    fwd_k, bwd_k = kernel_counters()["B1"], kernel_counters()["B2"]
    per_step, step_s, snapshot, recorded = [], [], {}, []
    started = []

    def before_train(trainer):
        score_threshold_zero(trainer.model)
        if calibrate:
            calibrate_frozen_bn(trainer.model, noise_batch(device, 2, H, W, 38))
        snapshot.update({k: p.detach().clone() for k, p in trainer.model.named_parameters()
                         if k.startswith(("backbone.bottom_up.", "roi_heads.")) and p.requires_grad})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_launches()
        fwd_k.paths = {}
        poolers.roi_align_multilevel = recording_pools(poolers, recorded, len(pools))  # after the calibration

    def after_step(trainer):
        per_step.append((fwd_k.launches, bwd_k.launches))
        step_s.append(time.perf_counter() - started[-1])

    pool_entry = poolers.roi_align_multilevel
    t0 = time.perf_counter()
    try:
        trainer = tool.main(args, extra_hooks=[hooks.CallbackHook(
            before_train=before_train, before_step=lambda t: started.append(time.perf_counter()), after_step=after_step)])
    finally:
        poolers.roi_align_multilevel = pool_entry
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, storage = trainer.model, trainer.storage
    n = len(pools)
    steps = step_launches(per_step)
    check(len(steps) == iters and all(s == (n, n) for s in steps), f"{label}: per-step (B1, B2) launches {steps}")
    launches = (fwd_k.launches, bwd_k.launches)  # the run's, before the comparisons below launch more
    eval_fwd = launches[0] - per_step[-1][0]
    check(eval_fwd == n * BACKBONE_TEST_IMAGES and launches[1] == n * iters, (eval_fwd, launches))
    check(set(fwd_k.paths) == {"vector"}, fwd_k.paths)
    no_attention_launches(label)
    check_loss_values(storage, sorted(k for k in storage.histories() if k.startswith("loss_")), iters)
    moved = sum(not torch.equal(p.detach(), snapshot[k]) for k, p in model.named_parameters() if k in snapshot)
    check(moved >= 0.9 * len(snapshot), f"{label}: {moved} of {len(snapshot)} backbone and ROI head tensors moved")
    ap = {task: storage.latest()[f"{task}/AP"][0] for task in ("bbox", "segm")}
    check(all(math.isfinite(v) and 0 <= v <= 100 for v in ap.values()), ap)
    # steps 2 to iters - 1: the first meets cold caches, the last writes the final checkpoint
    data = [v for v, _ in storage.history("data_time").values()][1:-1]
    step_ms, data_ms = float(np.median(step_s[1:-1])) * 1e3, float(np.median(data)) * 1e3
    share = sum(data) / sum(step_s[1:-1])
    log(f"  {label}: {iters} steps at {batch} images + the evaluation over {BACKBONE_TEST_IMAGES} in {train_s:.2f} s; "
        f"{moved} of {len(snapshot)} backbone and ROI head tensors moved; bbox AP {ap['bbox']:.4f}, segm AP {ap['segm']:.4f}; "
        f"launches B1 {launches[0]} ({eval_fwd} in eval), B2 {launches[1]}")
    log(f"  {card}: steps 2-{iters - 1}: median step {step_ms:.1f} ms, median data_time {data_ms:.1f} ms, "
        f"{batch / step_ms * 1e3:.2f} img/s; waiting on the loader {share:.1%}; peak memory {peak:.2f} GiB")
    log("  step times (ms): " + ", ".join(f"{s * 1e3:.1f}" for s in step_s))
    levels = [tuple(f.shape[1:3]) for f in recorded[0]["args"][0]]
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-batch (levels {levels})", keys=pools)
    del trainer, model, storage
    free_card()
    return {"ms_per_step": step_ms, "data_ms_per_step": data_ms, "img_s": batch / step_ms * 1e3, "data_share": share,
            "peak_gib": peak, "ap": ap, "launches": launches, "fwd": fwd, "bwd": bwd}


def backbone_result(prefix: str, inference: dict = None, train: dict = None) -> dict:
    """A path's numbers under ``prefix`` for the main_path entry."""
    out = {}
    if inference:
        out.update({f"{prefix}_{k}": inference[k] for k in ("batch_ms", "first_batch_ms", "img_s", "peak_gib")})
        if "request_ms" in inference:
            out[f"{prefix}_request_ms"] = inference["request_ms"]
    if train:
        out.update({f"{prefix}_train_{k}": train[k] for k in (
            "ms_per_step", "data_ms_per_step", "img_s", "data_share", "peak_gib", "train_s") if k in train})
        out.update({f"{prefix}_train_{t}_AP": v for t, v in train.get("ap", {}).items()})
    return out


def phase_mvit(device, card: str, workdir: str, coco):
    """MViTv2: ``configs/ViTDet/cascade_mask_rcnn_mvitv2_b_in21k_100ep.py``
    (MViTv2-B, 24 blocks, DropPath 0.4, LN FPN, 3-stage cascade): 2
    requests, a batch forward of 8 x 1024x1024, B1 four times a forward,
    then BACKBONE_ITERS steps at 8 images (for the config's 64, LSJ onto
    1024) through ``lazyconfig_train_net``; ``configs/MViTv2/mask_rcnn_mvitv2_
    t_3x.py`` (MViTv2-T): one batch forward of 16 x 800x1344, whose 200x336
    first stage pads its 56x56 windows."""
    t_phase = time.perf_counter()
    model = lazy_zoo_model(device, MVIT_B_CONFIG)
    net = model.backbone.bottom_up
    check((type(net).__name__, net.depths, net.embed_dim, len(model.roi_heads.box_head)) == ("MViT", (2, 3, 16, 3), 96, 3),
          f"{MVIT_B_CONFIG} as the zoo has it")
    log(f"  {MVIT_B_CONFIG}: {sum(p.numel() for p in model.parameters())} parameters")
    inf = backbone_inference(model, "MViTv2-B cascade", noise_batch(device, VIT_B, VIT_HW, VIT_HW, 36), (VIT_HW, VIT_HW),
                             CASCADE_POOLS)
    del model
    free_card()
    train = backbone_train(device, card, workdir, coco, "MViTv2-B cascade", MVIT_B_CONFIG, "mvit_b", VIT_B, BACKBONE_ITERS,
                           CASCADE_POOLS)
    model = lazy_zoo_model(device, MVIT_T_CONFIG)
    check(model.backbone.bottom_up.depths == (1, 2, 5, 2), f"{MVIT_T_CONFIG} as the zoo has it")
    tiny = backbone_inference(model, "MViTv2-T", noise_batch(device, B, H, W, 37), None, MASK_RCNN_POOLS, requests=False)
    del model
    free_card()
    return {**backbone_result("mvit_b", inf, train), **backbone_result("mvit_t", tiny),
            "mvit_phase_s": time.perf_counter() - t_phase,
            "b1_launches": inf["launches"] + train["launches"][0] + tiny["launches"], "b2_launches": train["launches"][1],
            "pools": {"mvit_b": inf["pools"], "mvit_t": tiny["pools"]},
            "train_fwd": {"mvit_b": train["fwd"]}, "train_bwd": {"mvit_b": train["bwd"]}}


def phase_swin(device, card: str, workdir: str, coco):
    """Swin: ``configs/ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py``
    (Swin-B, 2-2-18-2 blocks, 7x7 windows, whose 256x256 first stage at
    1024 pads to 259; DropPath 0.4, LN FPN, 3-stage cascade): 2 requests, a
    batch forward of 8 x 1024x1024, then BACKBONE_ITERS steps at 8 images."""
    t_phase = time.perf_counter()
    model = lazy_zoo_model(device, SWIN_B_CONFIG)
    net = model.backbone.bottom_up
    check((type(net).__name__, net.depths, net.embed_dim) == ("SwinTransformer", (2, 2, 18, 2), 128),
          f"{SWIN_B_CONFIG} as the zoo has it")
    log(f"  {SWIN_B_CONFIG}: {sum(p.numel() for p in model.parameters())} parameters")
    inf = backbone_inference(model, "Swin-B cascade", noise_batch(device, VIT_B, VIT_HW, VIT_HW, 37), (VIT_HW, VIT_HW),
                             CASCADE_POOLS)
    del model
    free_card()
    train = backbone_train(device, card, workdir, coco, "Swin-B cascade", SWIN_B_CONFIG, "swin_b", VIT_B, BACKBONE_ITERS,
                           CASCADE_POOLS)
    return {**backbone_result("swin_b", inf, train), "swin_phase_s": time.perf_counter() - t_phase,
            "b1_launches": inf["launches"] + train["launches"][0], "b2_launches": train["launches"][1],
            "pools": {"swin_b": inf["pools"]}, "train_fwd": {"swin_b": train["fwd"]}, "train_bwd": {"swin_b": train["bwd"]}}


def phase_regnet(device, card: str, workdir: str, coco):
    """RegNet: ``configs/COCO-InstanceSegmentation/mask_rcnn_regnetx_4gf_dds_
    fpn_1x.py`` (RegNetX-4GF, FrozenBN calibrated on two noise images, SGD;
    built by the config's own ``GeneralizedRCNN.from_config(cfg).clone(
    backbone=...)``): 2 requests, a batch forward of 16 x 800x1344, then
    BACKBONE_ITERS steps at its 16 images; ``configs/new_baselines/mask_rcnn_
    regnety_4gf_dds_FPN_100ep_LSJ.py`` (RegNetY-4GF, SE, SyncBN under batch
    statistics in every conv): REGNETY_ITERS steps at 8 images of 1024x1024."""
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn

    t_phase = time.perf_counter()
    model = lazy_zoo_model(device, REGNETX_CONFIG)
    net = model.backbone.bottom_up
    check((type(net).__name__, [s.channels for s in net.output_shape().values()]) == ("RegNet", [80, 240, 560, 1360]),
          f"{REGNETX_CONFIG} as the zoo has it")
    log(f"  {REGNETX_CONFIG}: {sum(p.numel() for p in model.parameters())} parameters")
    batch = noise_batch(device, B, H, W, 38)
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    inf = backbone_inference(model, "RegNetX-4GF", batch, (800, 1333), MASK_RCNN_POOLS)
    del model, batch
    free_card()
    x = backbone_train(device, card, workdir, coco, "RegNetX-4GF", REGNETX_CONFIG, "regnetx", REGNETX_TRAIN_BATCH,
                       BACKBONE_ITERS, MASK_RCNN_POOLS, calibrate=True)
    y = backbone_train(device, card, workdir, coco, "RegNetY-4GF LSJ", REGNETY_CONFIG, "regnety", REGNETY_TRAIN_BATCH,
                       REGNETY_ITERS, MASK_RCNN_POOLS)
    return {**backbone_result("regnetx", inf, x), **backbone_result("regnety", None, y),
            "regnet_phase_s": time.perf_counter() - t_phase,
            "b1_launches": inf["launches"] + x["launches"][0] + y["launches"][0],
            "b2_launches": x["launches"][1] + y["launches"][1],
            "pools": {"regnetx": inf["pools"]}, "train_fwd": {"regnetx": x["fwd"], "regnety": y["fwd"]},
            "train_bwd": {"regnetx": x["bwd"], "regnety": y["bwd"]}}


BACKBONE_PHASES = (
    (36, "MViTv2: cascade MViTv2-B requests, batch forward and lazyconfig_train_net; MViTv2-T batch forward", phase_mvit),
    (37, "Swin: cascade Swin-B requests, batch forward and lazyconfig_train_net", phase_swin),
    (38, "RegNet: RegNetX-4GF requests, batch forward and training; RegNetY-4GF LSJ training", phase_regnet),
)


def backbone_pools(backbones: dict, kind: str) -> list:
    """Every recorded pool set of phases 36-38: the forwards' and the first
    train batches' (``kind`` "fwd"), or the train batches' backward ("bwd")."""
    out = [pools for r in backbones.values() for pools in r["train_" + kind].values()]
    return out + ([pools for r in backbones.values() for pools in r["pools"].values()] if kind == "fwd" else [])


def backbone_entries(backbones: dict, kind: str) -> dict:
    """Phases 36-38's pools in the kernels line, one entry a path."""
    out = {}
    for r in backbones.values():
        if kind == "fwd":
            out.update({name: pools_entry(pools, BACKBONE_PER[name]) for name, pools in r["pools"].items()})
        out.update({f"{name}_train": pools_entry(pools, ("backward of " if kind == "bwd" else "") + BACKBONE_PER[f"{name}_train"])
                    for name, pools in r["train_" + kind].items()})
    return out


def run_backbone_phases(timed, device, card: str, workdir: str, coco) -> dict:
    out = {}
    for n, title, fn in BACKBONE_PHASES:
        with attention_free(f"phase {n}"):
            out[n] = timed(n, title, fn, device, card, workdir, coco)
    return out


# ---------------------------------------------------------------- phases 39-40
# deformable convolution (plain PyTorch, as the JAX package's XLA op: no
# kernel of its own) in the dconv Mask R-CNN and the panoptic R101 yaml, and
# the chart DensePose R-CNN: the decoder config, the _legacy FPN pool and the
# DeepLab head with the iid UV confidence
DCONV_CONFIG = "Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml"
DCONV_PANOPTIC_CONFIG = "Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"
DENSEPOSE_CONFIGS = {
    "densepose": "DensePose/densepose_rcnn_R_50_FPN_s1x.yaml",
    "densepose_legacy": "DensePose/densepose_rcnn_R_50_FPN_s1x_legacy.yaml",
    "densepose_dl": "DensePose/densepose_rcnn_R_50_FPN_DL_WC1_s1x.yaml",
}
# the smoke run's cuts (PERF.md section 4): 4 steps of the dconv yaml and of
# the DensePose decoder config at their 16 images, 2 of the other two; one
# panoptic forward; 16 images a DensePose train split, 2 in minival
DCONV_TRAIN_ITERS = DENSEPOSE_TRAIN_ITERS = 4
DENSEPOSE_VARIANT_ITERS, DENSEPOSE_IMAGES, DENSEPOSE_TEST_IMAGES = 2, 16, 2
# each conv2_offset drawn at this many pixels' std (seeded weights give zero
# offsets, a plain conv that never reaches the bilinear path)
OFFSET_STD_PX = 2.0
DCONV_OP_REL_TOL = 1e-4  # the op's float32 output on the card vs float64 on the host
DENSEPOSE_PER = {
    "densepose": "box pool of one 16x800x1344 DensePose R-CNN forward (its DensePose pool is the decoder's, no kernel)",
    "densepose_legacy": "box pool + 14x14 DensePose pool (p2-p5) of one 16x800x1344 _legacy forward",
    "densepose_dl": "box pool of one 16x800x1344 DL_WC1 forward",
    "densepose_train": "box pool of the DensePose decoder config's first 16-image batch",
    "densepose_legacy_train": "box pool + 14x14 DensePose pool of the _legacy config's first 16-image batch",
    "densepose_dl_train": "box pool of the DL_WC1 config's first 16-image batch",
    "densepose_eval": "box pool of the decoder config's first --eval-only minival image",
}


def draw_offsets(model, gen, batch) -> int:
    """Every deformable block's ``conv2_offset`` drawn from ``gen`` (seeded
    weights give zero offsets, a plain conv that never reaches the bilinear
    path): a normal weight scaled so that its offsets on ``batch`` have a
    std of OFFSET_STD_PX pixels, a zero bias; the FrozenBN statistics
    calibrated on ``batch`` before and after. Returns the count."""
    import torch

    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.modeling.backbone.resnet import DeformBottleneckBlock

    blocks = [m for m in model.modules() if isinstance(m, DeformBottleneckBlock)]
    with torch.no_grad():
        for b in blocks:
            w = b.conv2_offset.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
            b.conv2_offset.bias.zero_()
    calibrate_frozen_bn(model, batch)
    stds = {}

    def measure(block):
        def hook(module, args, out):
            stds.setdefault(block, out[:, : 18 * block.conv2.deformable_groups].float().std().item())

        return hook

    handles = [b.conv2_offset.register_forward_hook(measure(b)) for b in blocks]
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        for b in blocks:
            b.conv2_offset.weight.mul_(OFFSET_STD_PX / stds[b])
    calibrate_frozen_bn(model, batch)
    return len(blocks)


class OffsetStats:
    """Forward hooks on every deformable block, read in the first forward of
    a B-image batch (a request's resized image differs from the noise the
    offsets were scaled on): the offsets' std, largest length and
    fractional share, the share of res3.0's samples outside its map, and
    res3.0's deformable conv inputs (for the op check)."""

    def __init__(self, model):
        from detectron2_tpu_torch.modeling.backbone.resnet import DeformBottleneckBlock

        self.stats, self.inputs, self._handles, self.first = {}, None, [], None
        for name, b in model.backbone.bottom_up.named_modules():
            if isinstance(b, DeformBottleneckBlock):
                self._handles.append(b.conv2_offset.register_forward_hook(self._offsets(name, b)))
                if self.first is None:  # res3.0
                    self.first = name
                    self._handles.append(b.conv2.register_forward_pre_hook(self._record))

    def _offsets(self, name, block):
        import torch

        def hook(module, args, out):
            if name in self.stats or out.shape[0] != B:
                return
            off = out[:, : 18 * block.conv2.deformable_groups].float()
            frac = (off - off.round()).abs() > 1e-3
            self.stats[name] = {"std": off.std().item(), "max": off.abs().max().item(), "fractional": frac.float().mean().item()}
            if name == self.first:
                c = block.conv2
                nb, _, Ho, Wo = off.shape
                h, w = args[0].shape[2], args[0].shape[3]
                o = off.permute(0, 2, 3, 1).reshape(nb, Ho, Wo, -1, 9, 2)
                k = torch.arange(3, device=off.device) * c.dilation
                ys = (torch.arange(Ho, device=off.device) * c.stride - c.padding)[:, None, None] + k[None, :, None]
                xs = (torch.arange(Wo, device=off.device) * c.stride - c.padding)[:, None, None] + k[None, None, :]
                sy = ys.reshape(Ho, 1, 1, 3, 1).expand(Ho, Wo, 1, 3, 3).reshape(Ho, Wo, 1, 9) + o[..., 0]
                sx = xs.reshape(1, Wo, 1, 1, 3).expand(Ho, Wo, 1, 3, 3).reshape(Ho, Wo, 1, 9) + o[..., 1]
                out_of_map = (sy <= -1) | (sy >= h) | (sx <= -1) | (sx >= w)
                self.stats[name]["outside"] = out_of_map.float().mean().item()

        return hook

    def _record(self, module, args):
        if self.inputs is None and args[0].shape[0] == B:
            x, offset = args[0], args[1]
            self.inputs = (x.detach().clone(), offset.detach().clone(), module)

    def remove(self):
        for h in self._handles:
            h.remove()

    def checked(self, label: str) -> dict:
        s = self.stats
        check(s and all(0.25 * OFFSET_STD_PX < v["std"] < 4 * OFFSET_STD_PX and v["max"] > 1 and v["fractional"] > 0.9
                        for v in s.values()), f"{label}: offsets {s}")
        check(0 < s[self.first]["outside"] < 0.5, f"{label}: samples outside res3's map {s[self.first]}")
        log(f"  {label}: {len(s)} deformable blocks, offset std {min(v['std'] for v in s.values()):.2f}-"
            f"{max(v['std'] for v in s.values()):.2f} px, largest {max(v['max'] for v in s.values()):.1f} px, fractional "
            f"{min(v['fractional'] for v in s.values()):.4f}; {s[self.first]['outside']:.2%} of {self.first}'s samples "
            f"outside its map")
        return s


def dconv_op_check(inputs, card: str) -> dict:
    """The op on one recorded res3 input (the first two images): float32 on
    the card against float64 on the host, within DCONV_OP_REL_TOL of the
    largest |value|; and the op's time in bf16 on the whole batch beside a
    plain 3x3 conv (cuDNN) of the same shape."""
    import torch
    import torch.nn.functional as F

    from detectron2_tpu_torch.layers import nhwc
    from detectron2_tpu_torch.ops.deform_conv import deform_conv2d

    x, offset, conv = inputs
    kw = dict(stride=conv.stride, padding=conv.padding, dilation=conv.dilation, groups=conv.groups,
              deformable_groups=conv.deformable_groups)
    w = conv.weight.detach().permute(2, 3, 1, 0)
    with torch.inference_mode():
        x32, off32 = x[:2].float().contiguous(), offset[:2].float().contiguous()
        out32 = deform_conv2d(x32, off32, w.float(), **kw)
        ref = deform_conv2d(x32.double().cpu(), off32.double().cpu(), w.double().cpu(), **kw)
        err = (out32.double().cpu() - ref).abs().max().item() / ref.abs().max().item()
        check(err <= DCONV_OP_REL_TOL, f"deform_conv2d float32 on the card vs float64: {err:.3e} relative")
        wb = w.to(x.dtype)
        op_ms = event_ms(lambda: deform_conv2d(x, offset, wb, **kw), 1, 3)
        xc, wc = x.permute(0, 3, 1, 2), conv.weight.detach().to(x.dtype)
        conv_ms = event_ms(lambda: F.conv2d(xc, wc, None, conv.stride, conv.padding, conv.dilation, conv.groups), 1, 3)
    log(f"  deform_conv2d on res3.0's recorded input {tuple(x[:2].shape)} + offsets {tuple(offset[:2].shape)}: float32 on "
        f"the card vs float64 on the host, max |err| / max |ref| {err:.3e} (tol {DCONV_OP_REL_TOL:.0e})")
    log(f"  {card}: deform_conv2d bf16 on the batch's {tuple(x.shape)}: {op_ms:.3f} ms; a plain 3x3 conv (cuDNN) of "
        f"the same shape {conv_ms:.3f} ms")
    return {"op_rel_err": err, "op_ms": op_ms, "plain_conv_ms": conv_ms}


def seeded_dconv_model(device, config: str, seed: int):
    """A zoo yaml with deformable convs on the card in bf16 at score
    threshold 0: seeded weights, the offsets drawn and on two images of a 16 x 800x1344 noise batch
    (``draw_offsets``); returns (cfg, predictor, batch)."""
    import torch

    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import init_weights

    cfg = model_zoo.get_config(config)
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    predictor = DefaultPredictor(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_weights(predictor.model, gen)
    batch = noise_batch(device, B, H, W, seed)
    n = draw_offsets(predictor.model, gen, {k: v[:2] for k, v in batch.items()})
    log(f"  {config}: {sum(p.numel() for p in predictor.model.parameters())} parameters, {n} deformable blocks")
    return cfg, predictor, batch


def phase_dconv(device, card: str, workdir: str, coco):
    """Deformable convolution: ``Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml``
    (v1 deformable convs in res3-res5's 13 blocks; bf16, seeded weights, the
    offsets drawn at OFFSET_STD_PX): 2 requests and a batch forward of 16 x
    800x1344 (B1 twice a forward, held on the recorded pools), the op on
    res3.0's recorded input in float32 against float64 on the host, then
    DCONV_TRAIN_ITERS DefaultTrainer steps at the yaml's 16 images on the
    synthetic COCO (B1/B2 twice a step, held on the first batch; the offset
    convs move; the peak recorded); one batch forward of
    ``Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml`` (R101 with GN,
    cascade, deformable res3-res5), B1 four times, held on its pools."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.modeling import build_model, init_weights
    from detectron2_tpu_torch.modeling.backbone.resnet import DeformBottleneckBlock
    from detectron2_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    fwd_k, bwd_k = kernel_counters()["B1"], kernel_counters()["B2"]
    cfg, predictor, batch = seeded_dconv_model(device, DCONV_CONFIG, 39)
    r = cfg.MODEL.RESNETS
    check((r.DEPTH, tuple(r.DEFORM_ON_PER_STAGE), r.DEFORM_MODULATED, cfg.MODEL.MASK_ON)
          == (50, (False, True, True, True), False, True), f"{DCONV_CONFIG} as the zoo has it")
    model = predictor.model
    stats = OffsetStats(model)
    try:
        inf = backbone_inference(model, "dconv R50-FPN", batch, (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST),
                                 MASK_RCNN_POOLS)
    finally:
        stats.remove()
    offsets = stats.checked("dconv R50-FPN")
    op = dconv_op_check(stats.inputs, card)
    del model, predictor, batch, stats
    free_card()

    # DefaultTrainer at the yaml's input
    train_name, _ = register_dense_sets(coco, workdir, "chip_smoke_dconv")
    tcfg = zoo_train_config(DCONV_CONFIG, train_name, train_name, os.path.join(workdir, "dconv"), DCONV_TRAIN_ITERS)
    tcfg.MODEL.WEIGHTS = ""
    tcfg.DATASETS.TEST = ()
    trainer = yaml_trainer(train_net)(tcfg)
    trainer.resume_or_load(resume=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(39)
    calib = next(iter(build_detection_test_loader(tcfg, train_name, batch_size=4)))
    draw_offsets(trainer.model, gen, {k: v for k, v in calib.items() if k != "metadata"})
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
              if p.requires_grad and ("conv2_offset" in k or ".conv2." in k)}
    check(len(before) == 13 * 3, f"{len(before)} trainable offset-conv and deformable-conv tensors")
    recorded = []
    _, steps, train_s, train_peak = train_counted(trainer, recorded, 2)
    check(len(steps) == DCONV_TRAIN_ITERS and all(s == (2, 2) for s in steps), f"per-step (B1, B2) launches {steps}")
    train_launches = (fwd_k.launches, bwd_k.launches)
    check_loss_values(trainer.storage, LOSSES, DCONV_TRAIN_ITERS)
    moved(trainer.model, before)
    log(f"  {DCONV_TRAIN_ITERS} steps at {tcfg.SOLVER.IMS_PER_BATCH} images in {train_s:.2f} s; every one of the "
        f"{len(before)} offset-conv and deformable-conv tensors moved; peak memory {train_peak:.2f} GiB")
    train = {**step_times(trainer.storage, tcfg.SOLVER.IMS_PER_BATCH, card, train_peak), "peak_gib": train_peak}
    train_fwd, train_bwd = compare_recorded_pools(recorded, "dconv first-batch")
    del trainer
    free_card()

    # the panoptic R101 yaml: one batch forward
    pcfg = model_zoo.get_config(DCONV_PANOPTIC_CONFIG)
    pr = pcfg.MODEL.RESNETS
    check((pcfg.MODEL.META_ARCHITECTURE, pcfg.MODEL.ROI_HEADS.NAME, pr.DEPTH, pr.NORM, tuple(pr.DEFORM_ON_PER_STAGE))
          == ("PanopticFPN", "CascadeROIHeads", 101, "GN", (False, True, True, True)), f"{DCONV_PANOPTIC_CONFIG} as the zoo has it")
    pcfg.MODEL.WEIGHTS = ""
    pcfg.TPU.COMPUTE_DTYPE = "bfloat16"
    pcfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    model = build_model(pcfg, device=device)
    gen.manual_seed(391)
    init_weights(model, gen)
    batch = noise_batch(device, B, H, W, 391)
    n_blocks = draw_offsets(model, gen, {k: v[:2] for k, v in batch.items()})
    check(n_blocks == 4 + 23 + 3 and all(isinstance(b, DeformBottleneckBlock) for b in model.backbone.bottom_up.res4),
          n_blocks)
    recorded = []
    kernel_entry = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = recording_entry(poolers, recorded, len(CASCADE_POOLS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = model(batch)
            torch.cuda.synchronize()
            pan_ms = (time.perf_counter() - t0) * 1e3
    finally:
        poolers.roi_align_multilevel = kernel_entry
    pan_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {name: k.launches for name, k in kernel_counters().items()}
    check(counts == {"B1": len(CASCADE_POOLS), "B2": 0, "B3": 0, "B4": 0}, f"panoptic dconv launches {counts}")
    sem = out["sem_seg"]
    check(sem.shape[:3] == (B, H, W) and torch.isfinite(sem).all() and torch.isfinite(out["pred_masks"]).all(), sem.shape)
    check(min(out["valid"].sum(1).tolist()) > 0)
    log(f"  {DCONV_PANOPTIC_CONFIG}: one batch forward {B}x{H}x{W} in {pan_ms:.1f} ms (the first: cold caches); peak memory "
        f"{pan_peak:.2f} GiB; B1 launches {counts['B1']}")
    del out
    with torch.inference_mode():
        pan_pools = compare_pools(recorded, CASCADE_POOLS, "dconv panoptic cascade")
    del model, batch
    free_card()
    no_attention_launches("deformable conv")
    return {
        **backbone_result("dconv", inf, train),
        "dconv_offsets": offsets, **{f"dconv_{k}": v for k, v in op.items()},
        "dconv_panoptic_first_batch_ms": pan_ms, "dconv_panoptic_peak_gib": pan_peak,
        "dconv_phase_s": time.perf_counter() - t_phase,
        "b1_launches": inf["launches"] + train_launches[0] + counts["B1"], "b2_launches": train_launches[1],
        "pools": {"dconv": (inf["pools"], "box pool + mask pool of one 16x800x1344 dconv R50-FPN forward"),
                  "dconv_panoptic": (pan_pools, "3 stage box pools + mask pool of one 16x800x1344 panoptic R101 dconv forward")},
        "train_fwd": {"dconv": (train_fwd, "box pool + mask pool of the dconv run's first 16-image batch")},
        "train_bwd": {"dconv": (train_bwd, "box pool + mask pool of the dconv run's first 16-image batch")},
    }


def densepose_data() -> dict:
    """The synthetic DensePose-COCO under the run's ``$DETECTRON2_DATASETS``
    (the builtin names): DENSEPOSE_IMAGES images in each train split, the
    minival test split DENSEPOSE_TEST_IMAGES."""
    from detectron2_tpu_torch.testing import write_synthetic_densepose_coco

    root = os.environ["DETECTRON2_DATASETS"]
    t0 = time.perf_counter()
    write_synthetic_densepose_coco(root, DENSEPOSE_IMAGES, seed=40,
                                   splits=("densepose_coco_2014_train", "densepose_coco_2014_valminusminival"))
    write_synthetic_densepose_coco(root, DENSEPOSE_TEST_IMAGES, seed=41, splits=("densepose_coco_2014_minival",))
    return {"write_s": time.perf_counter() - t0}


def densepose_cfg(name: str, opts=()):
    """``densepose_train_net.setup`` of a DensePose yaml (``get_cfg``,
    ``add_densepose_config``, the yaml, ``opts``) in bf16 with seeded
    weights, checked as the zoo has it."""
    from detectron2_tpu_torch.engine import default_argument_parser
    from detectron2_tpu_torch.tools import densepose_train_net as tool

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", DENSEPOSE_CONFIGS[name])
    args = default_argument_parser().parse_args(
        ["--config-file", path, "MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE", "bfloat16", "SEED", "0", *opts]
    )
    cfg = tool.setup(args)
    h, i = cfg.MODEL.ROI_DENSEPOSE_HEAD, cfg.INPUT
    check((cfg.MODEL.ROI_HEADS.NAME, cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.SOLVER.IMS_PER_BATCH, tuple(i.MIN_SIZE_TRAIN),
           i.MAX_SIZE_TRAIN, cfg.DATASETS.TRAIN, cfg.DATASETS.TEST, h.DECODER_ON, h.NAME, h.UV_CONFIDENCE.ENABLED)
          == ("DensePoseROIHeads", 1, 16, (640, 672, 704, 736, 768, 800), 1333,
              ("densepose_coco_2014_train", "densepose_coco_2014_valminusminival"), ("densepose_coco_2014_minival",),
              name != "densepose_legacy", "DensePoseDeepLabHead" if name == "densepose_dl" else "DensePoseV1ConvXHead",
              name == "densepose_dl"), f"{DENSEPOSE_CONFIGS[name]} as the zoo has it")
    return cfg


def check_densepose(dp, n: int, k: int) -> None:
    """``pred_densepose`` ``[n, D, M, M, 3]`` (or ``[D, M, M, 3]``): parts in
    0..24, U and V in [0, 1], zeros past the first ``k`` slots."""
    import torch

    check(torch.isfinite(dp).all() and dp.shape[-1] == 3 and dp.shape[-2] == dp.shape[-3], tuple(dp.shape))
    part = dp[..., 0]
    check(((part >= 0) & (part <= 24) & (part == part.round())).all(), "DensePose parts")
    check(((dp[..., 1:] >= 0) & (dp[..., 1:] <= 1)).all(), "DensePose U/V")
    # slots come score-sorted; a request's dropped boxes only move later rows up
    rows = dp[:, k:] if dp.dim() == 5 else dp[k:]
    check(dp.shape[0] == n and not rows.any(), f"{tuple(dp.shape)}: a DensePose result past the first {k} slots")


def densepose_inference(device, workdir: str, name: str, label: str, requests: bool, sep_records=None,
                        levels=None) -> dict:
    """A DensePose yaml with seeded, calibrated weights (FrozenBN and BN,
    ``calibrate_norms``) at score threshold 0: with ``requests``,
    BACKBONE_REQUESTS through DefaultPredictor (each detection's
    ``pred_densepose`` checked); one recorded and one timed batch forward at
    16 x 800x1344; B1 once a pool a forward (the box pool, and the FPN
    DensePose pool without the decoder), held on the recorded pools, the
    box pool over ``levels`` levels when given; with ``sep_records``, the
    decoder pool's inputs recorded into it."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    import detectron2_tpu_torch.projects.densepose.roi_heads as dp_heads
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import init_weights

    cfg = densepose_cfg(name, ["OUTPUT_DIR", os.path.join(workdir, f"{name}_inference")])
    cfg.defrost()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    predictor = DefaultPredictor(cfg, device=device)
    model = predictor.model
    gen = torch.Generator(device=device)
    gen.manual_seed(40)
    init_weights(model, gen)
    batch = noise_batch(device, B, H, W, 40)
    calibrate_norms(model, {k: v[:2] for k, v in batch.items()})
    pools = ("box",) if cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON else ("box", "densepose")
    K, D = cfg.MODEL.ROI_DENSEPOSE_HEAD.MAX_INFERENCE_INSTANCES, cfg.TEST.DETECTIONS_PER_IMAGE
    fwd_k = kernel_counters()["B1"]
    out = {}
    zero_kernel_launches()
    if requests:
        rng = np.random.RandomState(40)
        ms = []
        for h, w in BACKBONE_REQUESTS:
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            t0 = time.perf_counter()
            inst = predictor(img)["instances"]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(len(inst) > 0 and torch.isfinite(inst.pred_boxes.tensor).all(), f"{label}: {len(inst)} detections")
            check_densepose(inst.pred_densepose, len(inst), K)
            check(inst.pred_densepose[:K, ..., 0].any(), f"{label}: no body part in the first {K} detections")
        check(fwd_k.launches == len(pools) * len(BACKBONE_REQUESTS), f"{label}: B1 launches over the requests {fwd_k.launches}")
        out["request_ms"] = ms
        log(f"  {label}: {len(ms)} requests " + ", ".join(f"{h}x{w} {m:.1f} ms" for (h, w), m in zip(BACKBONE_REQUESTS, ms)))
    request_launches = fwd_k.launches
    recorded = []
    patches = [(poolers, "roi_align_multilevel", lambda _: recording_entry(poolers, recorded, len(pools)))]
    if sep_records is not None:
        def recording_sep(fn):
            def rec(*args, **kwargs):
                if not sep_records:
                    sep_records.append((args, kwargs))
                return fn(*args, **kwargs)
            return rec
        patches.append((dp_heads, "roi_align_separable_chan", recording_sep))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with torch.inference_mode():
        with _Patched(patches):
            t0 = time.perf_counter()
            det = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        det = model(batch)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: c.launches for k, c in kernel_counters().items()}
    check(counts == {"B1": 2 * len(pools), "B2": 0, "B3": 0, "B4": 0}, f"{label}: launches {counts}")
    check_densepose(det["pred_densepose"], B, K)
    check(det["pred_densepose"].shape[1] == D and min(det["valid"].sum(1).tolist()) > 0, tuple(det["pred_densepose"].shape))
    M = det["pred_densepose"].shape[2]
    log(f"  {label} batch forward {B}x{H}x{W}: first {first_ms:.1f} ms, then {batch_ms:.1f} ms ({B / batch_ms * 1e3:.2f} img/s); "
        f"peak memory {peak:.2f} GiB; pred_densepose {tuple(det['pred_densepose'].shape)} ({K} of {D} slots run, "
        f"{M}x{M}); B1 launches {counts['B1']}, {len(pools)} a forward")
    del det
    if levels is not None:
        check(len(recorded[0][0][0]) == levels, f"{label}: the box pool over {len(recorded[0][0][0])} levels")
    with torch.inference_mode():
        out["pools"] = compare_pools(recorded, pools, label)
    out.update(batch_ms=batch_ms, first_batch_ms=first_ms, img_s=B / batch_ms * 1e3, peak_gib=peak,
               launches=request_launches + counts["B1"])
    del model, predictor, batch
    free_card()
    return out


def separable_chan_check(sep_records, card: str) -> dict:
    """The decoder pool on its recorded inputs: ``roi_align_separable_chan``
    on the card in float32 against ``roi_align_multilevel_plain`` on the
    one level, within 1e-5 of the largest |value| (at least 1e-5); its time
    in bf16 as run."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_plain, roi_align_separable_chan

    check(len(sep_records) == 1, len(sep_records))
    (dec, boxes, res), kwargs = sep_records[0]
    Bd, K = boxes.shape[:2]
    with torch.inference_mode():
        out = roi_align_separable_chan(dec.float(), boxes, res, **kwargs).reshape(Bd * K, res, res, -1)
        bidx = torch.arange(Bd, dtype=torch.int32, device=boxes.device).repeat_interleave(K)
        ref = roi_align_multilevel_plain(
            [dec.float()], boxes.reshape(-1, 4).float().contiguous(), bidx, torch.zeros_like(bidx), (kwargs["spatial_scale"],),
            (res, res), kwargs["sampling_ratio"], kwargs["aligned"],
        )
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        check(err <= tol, f"roi_align_separable_chan vs the plain RoIAlign: {err:.3e} (tol {tol:.1e})")
        ms = event_ms(lambda: roi_align_separable_chan(dec, boxes, res, **kwargs), 1, 5)
    log(f"  the decoder pool: roi_align_separable_chan over {tuple(dec.shape)} ({dec.dtype}), {Bd}x{K} rois at {res}x{res} "
        f"(sampling ratio {kwargs['sampling_ratio']}, aligned {kwargs['aligned']}): float32 vs roi_align_multilevel_plain "
        f"max_abs_err {err:.3e} (tol {tol:.1e}); {card}: {ms:.3f} ms in {dec.dtype}")
    return {"separable_max_abs_err": err, "separable_ms": ms}


def densepose_train(device, card: str, workdir: str, name: str, label: str, iters: int) -> dict:
    """``densepose_train_net``'s setup and Trainer on the synthetic
    DensePose-COCO at the yaml's input (16 images, 640-800 / 1333, flips)
    with the smoke run's cuts (``zoo_train_config``'s: warmup over 100,
    gradients clipped to a global norm of 1, SEED 0), seeded weights with
    FrozenBN calibrated on 4 train images, ``iters`` steps; B1/B2 once a
    pool every step, held on the first batch; the DensePose losses finite;
    the DensePose head, predictor (and decoder) moved. The evaluation after
    training (the minival images, the synthetic SMPL tables) gives finite
    ``densepose_gps``, ``densepose_gpsm`` and ``densepose_segm``, B1 once a
    pool an image; the DensePose evaluator's seconds are logged."""
    import torch

    from detectron2_tpu_torch.projects.densepose import Trainer
    from detectron2_tpu_torch.projects.densepose.evaluation import DensePoseCOCOEvaluator

    class SmokeTrainer(Trainer):
        def build_writers(self):
            return []

    out_dir = os.path.join(workdir, name)
    cfg = densepose_cfg(name, ["SOLVER.MAX_ITER", str(iters), "SOLVER.WARMUP_ITERS", str(10 * TRAIN_STEPS),
                               "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0", "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", out_dir])
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    calibrate_on_train_images(trainer.model, cfg, cfg.DATASETS.TRAIN[0])
    n = 1 if cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON else 2
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
              if k.startswith(("roi_heads.densepose_", "roi_heads.decoder."))}
    recorded, eval_s = [], []
    _, steps, train_s, peak = train_counted(trainer, recorded, n, DensePoseCOCOEvaluator, eval_s)
    check(len(steps) == iters and all(s == (n, n) for s in steps), f"{label}: per-step (B1, B2) launches {steps}")
    launches = (kernel_counters()["B1"].launches, kernel_counters()["B2"].launches)
    check(launches[0] == n * (iters + DENSEPOSE_TEST_IMAGES), f"{label}: B1 launches {launches[0]} (steps and evaluation)")
    sections = check_densepose_sections(trainer._last_eval_results, f"{label} after training")
    log(f"  {label}: the evaluation after training ({DENSEPOSE_TEST_IMAGES} minival images): DensePose evaluator "
        f"{eval_s[0]:.2f} s; {sections}")
    dp_losses = sorted(k for k in trainer.storage.histories() if k.startswith("loss_densepose_"))
    check(len(dp_losses) == (3 if cfg.MODEL.ROI_DENSEPOSE_HEAD.UV_CONFIDENCE.ENABLED else 4), dp_losses)
    check_loss_values(trainer.storage, LOSSES[:2] + LOSSES[3:] + tuple(dp_losses), iters)
    moved(trainer.model, before)
    log(f"  {label}: {iters} steps at {cfg.SOLVER.IMS_PER_BATCH} images in {train_s:.2f} s; every one of the {len(before)} "
        f"DensePose head, predictor and decoder tensors moved; peak memory {peak:.2f} GiB; B1 {launches[0]}, B2 {launches[1]}")
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, peak) if iters > 3 else {"train_s": train_s}
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-batch", keys=(BOX_RES, "densepose")[:n])
    del trainer
    free_card()
    return {**stats, "peak_gib": peak, "launches": launches, "fwd": fwd, "bwd": bwd, "eval_s": eval_s[0]}


def check_densepose_sections(results: dict, label: str) -> str:
    """``densepose_gps``, ``densepose_gpsm`` and ``densepose_segm`` present,
    each its 10 finite numbers (AP, AP50, AP75, APm, APl, AR ... ARl); their
    APs as a line."""
    secs = ("densepose_gps", "densepose_gpsm", "densepose_segm")
    check(all(s in results for s in secs), f"{label}: {sorted(results)}")
    for sec in secs:
        check(len(results[sec]) == 10 and all(np.isfinite(v) for v in results[sec].values()), f"{label}: {sec} {results[sec]}")
    return ", ".join(f"{s} AP {results[s]['AP']:.3f}" for s in secs)


def densepose_eval_only(workdir: str) -> dict:
    """``densepose_train_net --eval-only`` of the decoder config on its
    DENSEPOSE_TEST_IMAGES minival images: seeded weights with FrozenBN
    calibrated on the first test image (``load_or_init``), score threshold
    0, COCOEvaluator and the DensePose evaluator with the synthetic SMPL
    tables; the three sections finite, the evaluator's seconds logged; B1
    once a forward (the box pool, the first image's held to its plain
    version)."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import default_argument_parser
    from detectron2_tpu_torch.projects.densepose.evaluation import DensePoseCOCOEvaluator
    from detectron2_tpu_torch.tools import densepose_train_net as tool

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", DENSEPOSE_CONFIGS["densepose"])
    args = default_argument_parser().parse_args(
        ["--config-file", path, "--eval-only", "MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE", "bfloat16", "SEED", "0",
         "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "OUTPUT_DIR", os.path.join(workdir, "densepose_eval_only")]
    )
    eval_s, recorded = [], []
    patches = [(DensePoseCOCOEvaluator, "evaluate", lambda _: timing_evaluate(DensePoseCOCOEvaluator, eval_s)),
               (poolers, "roi_align_multilevel", lambda _: recording_entry(poolers, recorded, 2))]
    zero_kernel_launches()
    t0 = time.perf_counter()
    with _Patched(patches):
        results = tool.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1 = kernel_counters()["B1"].launches
    check(b1 == 1 + DENSEPOSE_TEST_IMAGES, f"densepose --eval-only: B1 launches {b1} (calibration, then one an image)")
    sections = check_densepose_sections(results, "densepose --eval-only")
    log(f"  densepose_train_net --eval-only ({DENSEPOSE_TEST_IMAGES} minival images): {seconds:.2f} s, of which the "
        f"DensePose evaluator {eval_s[0]:.2f} s; bbox AP {results['bbox']['AP']:.3f}; {sections}; B1 launches {b1}")
    with torch.inference_mode():
        pools = compare_pools(recorded[1:], ["box"], "densepose --eval-only first image")
    return {"eval_only_s": seconds, "eval_s": eval_s[0], "launches": b1, "pools": pools}


def densepose_feedback(device) -> dict:
    """The minival ground truth fed back as the model's detections
    (``testing.densepose_ground_truth_outputs``, tensors on the card)
    through ``DensePoseCOCOEvaluator.process`` and its reading of the
    dataset: IOU mode must match every gt at IoU 1 (segm AP 100), GPS mode
    on the nearest annotated point's chart must reach AP 80."""
    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.projects.densepose.evaluation import DensePoseCOCOEvaluator, load_smpl_mesh_tables
    from detectron2_tpu_torch.testing import densepose_ground_truth_outputs

    name, out = "densepose_coco_2014_minival", {}
    for fill, mode, section, floor in (("masks", "iou", "densepose_segm", 100.0), ("points", "gps", "densepose_gps", 80.0)):
        evaluator = DensePoseCOCOEvaluator(name, load_smpl_mesh_tables(), mode=mode)
        evaluator.reset()
        for inputs, outputs in densepose_ground_truth_outputs(DatasetCatalog.get(name), fill, device=device):
            evaluator.process(inputs, outputs)
        res = evaluator.evaluate()[section]
        check(res["AP"] >= floor and res["AP50"] == 100.0, f"the ground truth fed back, {section}: {res}")
        out[section] = res["AP"]
    log(f"  the minival ground truth fed back through the DensePose evaluator: densepose_segm AP {out['densepose_segm']} "
        f"(IoU 1 at every gt), densepose_gps AP {out['densepose_gps']} (floor 80)")
    return out


def phase_densepose(device, card: str, workdir: str):
    """Chart DensePose R-CNN, zoo yamls through ``densepose_train_net``'s
    setup (bf16, seeded weights, score threshold 0) on a synthetic
    DensePose-COCO (``testing.write_synthetic_densepose_coco``) under the
    builtin ``densepose_coco_2014_*`` names: ``densepose_rcnn_R_50_FPN_s1x``
    (the FPN decoder, its 28x28 pool by ``roi_align_separable_chan``): 2
    requests and a batch forward of 16 x 800x1344 (B1 once a forward, the
    box pool; ``pred_densepose`` with the part in 0..24 and U/V in [0, 1]),
    the decoder pool held to the plain RoIAlign on the one level, then
    DENSEPOSE_TRAIN_ITERS steps at 16 images; the ``_legacy`` yaml (no
    decoder: its 14x14 DensePose pool over p2-p5 is B1's, B2's in training)
    and ``DL_WC1`` (the DeepLab head, the iid UV confidence): a batch forward
    and DENSEPOSE_VARIANT_ITERS steps each, each training followed by the
    DensePose evaluator; ``--eval-only`` of the decoder config; the minival
    ground truth fed back through the evaluator. B1/B2 held to their plain
    versions at every pool; B3/B4 0 times."""
    from detectron2_tpu_torch.testing import write_synthetic_densepose_eval_data

    t_phase = time.perf_counter()
    data = densepose_data()
    log(f"  synthetic DensePose-COCO: {DENSEPOSE_IMAGES} images in each train split, {DENSEPOSE_TEST_IMAGES} in minival, "
        f"under $DETECTRON2_DATASETS, written in {data['write_s']:.2f} s")
    root = os.environ["DETECTRON2_DATASETS"]
    smpl = write_synthetic_densepose_eval_data(root, seed=40)
    gib = os.path.getsize(os.path.join(root, "densepose_eval_data", "Pdist_matrix.pkl")) / 2**30
    log(f"  synthetic SMPL evaluation files (24 x 1148 vertices; the condensed geodesics over n = 27554, {gib:.2f} GiB) "
        f"written in {smpl['seconds']:.2f} s")
    sep = []
    res = {"densepose_write_s": data["write_s"], "densepose_smpl_write_s": smpl["seconds"]}
    pools, train_fwd, train_bwd = {}, {}, {}
    b1 = b2 = 0
    for name, label, requests, iters in (
        ("densepose", "DensePose R-CNN", True, DENSEPOSE_TRAIN_ITERS),
        ("densepose_legacy", "DensePose R-CNN _legacy", False, DENSEPOSE_VARIANT_ITERS),
        ("densepose_dl", "DensePose R-CNN DL_WC1", False, DENSEPOSE_VARIANT_ITERS),
    ):
        inf = densepose_inference(device, workdir, name, label, requests, sep if name == "densepose" else None)
        if name == "densepose":
            res.update({f"densepose_{k}": v for k, v in separable_chan_check(sep, card).items()})
            sep.clear()
        train = densepose_train(device, card, workdir, name, label, iters)
        res.update(backbone_result(name, inf, train))
        res[f"{name}_train_eval_s"] = train["eval_s"]
        if name == "densepose":
            ev = densepose_eval_only(workdir)
            res.update(densepose_eval_only_s=ev["eval_only_s"], densepose_eval_s=ev["eval_s"])
            res.update({f"densepose_feedback_{k}_ap": v for k, v in densepose_feedback(device).items()})
            pools["densepose_eval"] = (ev["pools"], DENSEPOSE_PER["densepose_eval"])
            b1 += ev["launches"]
        pools[name] = (inf["pools"], DENSEPOSE_PER[name])
        train_fwd[name] = (train["fwd"], DENSEPOSE_PER[f"{name}_train"])
        train_bwd[name] = (train["bwd"], DENSEPOSE_PER[f"{name}_train"])
        b1 += inf["launches"] + train["launches"][0]
        b2 += train["launches"][1]
    res.update(densepose_phase_s=time.perf_counter() - t_phase, b1_launches=b1, b2_launches=b2, pools=pools,
               train_fwd=train_fwd, train_bwd=train_bwd)
    return res


CSE_CONFIGS = {
    "densepose_cse": "DensePose/cse/densepose_rcnn_R_50_FPN_s1x.yaml",
    "densepose_animals": "DensePose/cse/densepose_rcnn_R_50_FPN_soft_animals_finetune_4k.yaml",
    "densepose_i2m": "DensePose/cse/densepose_rcnn_R_50_FPN_soft_animals_I0_finetune_i2m_16k.yaml",
    "densepose_m2m": "DensePose/cse/densepose_rcnn_R_50_FPN_soft_animals_I0_finetune_m2m_16k.yaml",
}
# the smoke run's cuts (PERF.md section 4): 4 steps of the human CSE config,
# 3 of the animal 4k config, 2 each of i2m and m2m; 16 images a train split,
# 2 in each test split
CSE_TRAIN_ITERS, ANIMALS_TRAIN_ITERS, CYCLE_TRAIN_ITERS = 4, 3, 2
CSE_IMAGES, CSE_TEST_IMAGES = 16, 2
ANIMAL_MESHES = ("bear_4936", "cat_5001", "cow_5002", "dog_5002", "elephant_5002", "giraffe_5002", "horse_5004",
                 "sheep_5004", "zebra_5002")
I0_MESHES = tuple(sorted(set(ANIMAL_MESHES) - {"cat_5001", "dog_5002"} | {"cat_7466", "dog_7466"}))
CSE_EXPECT = {  # NUM_CLASSES, loss, by masks, pix-to-shape, shape-to-shape, TRAIN, TEST, the embedders' meshes
    "densepose_cse": (1, "EmbeddingLoss", False, False, False,
                      ("densepose_coco_2014_train_cse", "densepose_coco_2014_valminusminival_cse"),
                      ("densepose_coco_2014_minival_cse",), ("smpl_27554",)),
    "densepose_animals": (9, "SoftEmbeddingLoss", True, False, False, ("densepose_lvis_v1_ds1_train_v1",),
                          ("densepose_lvis_v1_ds1_val_v1",), ANIMAL_MESHES),
    "densepose_i2m": (9, "SoftEmbeddingLoss", True, True, False, ("densepose_lvis_v1_ds2_train_v1",),
                      ("densepose_lvis_v1_ds2_val_v1",), I0_MESHES),
    "densepose_m2m": (9, "SoftEmbeddingLoss", True, False, True, ("densepose_lvis_v1_ds2_train_v1",),
                      ("densepose_lvis_v1_ds2_val_v1",), tuple(sorted(I0_MESHES + ("smpl_27554",)))),
}
DENSEPOSE_PER.update({
    "densepose_cse": "box pool of one 16x800x1344 human CSE R-CNN forward (its DensePose pool is the decoder's, no kernel)",
    "densepose_cse_train": "box pool of the human CSE config's first 16-image batch",
    "densepose_animals": "box pool of one 16x800x1344 animal CSE forward (9 classes)",
    "densepose_animals_train": "box pool of the animal CSE 4k config's first 16-image batch",
    "densepose_i2m_train": "box pool of the pixel-to-shape (i2m) config's first 16-image batch",
    "densepose_m2m_train": "box pool of the shape-to-shape (m2m) config's first 16-image batch",
})


def cse_cfg(name: str, features: dict, opts=()):
    """``densepose_train_net.setup`` of a CSE yaml in bf16 with seeded
    weights, each embedder's ``INIT_FILE`` pointed at the synthetic
    features (the yamls name downloads; unfilled, the features stay zero
    and the embedding loss has no gradient), checked as the zoo has it."""
    from detectron2_tpu_torch.engine import default_argument_parser
    from detectron2_tpu_torch.tools import densepose_train_net as tool

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", CSE_CONFIGS[name])
    init = [x for mesh in CSE_EXPECT[name][-1] for x in (f"MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS.{mesh}.INIT_FILE",
                                                         features[mesh])]
    args = default_argument_parser().parse_args(
        ["--config-file", path, "MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE", "bfloat16", "SEED", "0", *init, *opts]
    )
    cfg = tool.setup(args)
    h, i = cfg.MODEL.ROI_DENSEPOSE_HEAD, cfg.INPUT
    check((cfg.MODEL.ROI_HEADS.NUM_CLASSES, h.CSE.EMBED_LOSS_NAME, h.COARSE_SEGM_TRAINED_BY_MASKS,
           h.CSE.PIX_TO_SHAPE_CYCLE_LOSS.ENABLED, h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.ENABLED, cfg.DATASETS.TRAIN,
           cfg.DATASETS.TEST, tuple(sorted(h.CSE.EMBEDDERS))) == CSE_EXPECT[name]
          and (cfg.SOLVER.IMS_PER_BATCH, tuple(i.MIN_SIZE_TRAIN), i.MAX_SIZE_TRAIN, i.RANDOM_FLIP, h.CSE.EMBED_SIZE,
               h.PREDICTOR_NAME, h.DECODER_ON)
          == (16, (640, 672, 704, 736, 768, 800), 1333, "horizontal", 16, "DensePoseEmbeddingPredictor", True)
          and all(h.CSE.EMBEDDERS[m].FEATURE_DIM == 256 and h.CSE.EMBEDDERS[m].TYPE == "vertex_feature"
                  for m in h.CSE.EMBEDDERS), f"{CSE_CONFIGS[name]} as the zoo has it")
    return cfg


def check_cse(emb, fg, n: int, k: int, embed_size: int) -> None:
    """``pred_densepose_embedding`` ``[n, D, M, M, E]`` (or ``[D, M, M,
    E]``) finite, ``pred_densepose_fg`` boolean of its shape, zeros past the
    first ``k`` slots."""
    import torch

    check(torch.isfinite(emb).all() and emb.shape[-1] == embed_size and emb.shape[-2] == emb.shape[-3], tuple(emb.shape))
    check(fg.dtype == torch.bool and fg.shape == emb.shape[:-1], (fg.dtype, tuple(fg.shape)))
    rows = (emb[:, k:], fg[:, k:]) if emb.dim() == 5 else (emb[k:], fg[k:])
    check(emb.shape[0] == n and not rows[0].any() and not rows[1].any(), f"{tuple(emb.shape)}: output past {k} slots")


def calibrate_densepose(model, cfg, n: int = 4) -> None:
    """FrozenBN statistics from the first ``n`` train images, read as the
    DensePose trainer reads them (``densepose_dataset_dicts``)."""
    from detectron2_tpu_torch.data import build_detection_test_loader
    from detectron2_tpu_torch.data.build import PaddedBatchCollator
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn
    from detectron2_tpu_torch.projects.densepose import DensePoseDatasetMapper, densepose_dataset_dicts

    dicts = densepose_dataset_dicts(cfg, cfg.DATASETS.TRAIN)[:n]
    loader = build_detection_test_loader(dicts, mapper=DensePoseDatasetMapper(cfg, False), batch_size=n,
                                         collator=PaddedBatchCollator(size_bucket=cfg.TPU.SIZE_BUCKET))
    calibrate_frozen_bn(model, {k: v for k, v in next(iter(loader)).items() if k != "metadata"})


def cse_inference(device, model, cfg, label: str, batch, predictor=None) -> dict:
    """A CSE model at score threshold 0: with ``predictor``,
    BACKBONE_REQUESTS through it (each detection's embedding and
    foreground checked, the first detection's nearest vertices on its
    class's mesh in range); one recorded and one timed batch forward; B1
    once a forward (the box pool), held on the recorded pool."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers

    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    K, D, E = h.MAX_INFERENCE_INSTANCES, cfg.TEST.DETECTIONS_PER_IMAGE, h.CSE.EMBED_SIZE
    heads = model.roi_heads
    out = {}
    zero_kernel_launches()
    if predictor is not None:
        rng = np.random.RandomState(41)
        ms = []
        for hh, ww in BACKBONE_REQUESTS:
            img = rng.randint(0, 256, (hh, ww, 3)).astype(np.uint8)
            t0 = time.perf_counter()
            inst = predictor(img)["instances"]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(len(inst) > 0 and torch.isfinite(inst.pred_boxes.tensor).all(), f"{label}: {len(inst)} detections")
            check_cse(inst.pred_densepose_embedding, inst.pred_densepose_fg, len(inst), K, E)
            cls = int(inst.pred_classes[0])
            verts = heads.closest_vertices(inst.pred_densepose_embedding[0], cls)
            nv = heads.embedder(heads.class_to_mesh_name[cls]).shape[0]
            check(verts.shape == inst.pred_densepose_fg.shape[1:] and 0 <= int(verts.min()) and int(verts.max()) < nv,
                  f"{label}: nearest vertices of the first detection")
        check(kernel_counters()["B1"].launches == len(BACKBONE_REQUESTS), f"{label}: B1 over the requests")
        out["request_ms"] = ms
        log(f"  {label}: {len(ms)} requests " + ", ".join(f"{a}x{b} {m:.1f} ms" for (a, b), m in zip(BACKBONE_REQUESTS, ms))
            + f"; the first detection's nearest vertices on {heads.class_to_mesh_name[cls]} in range")
    request_launches = kernel_counters()["B1"].launches
    recorded = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    model.eval()
    with torch.inference_mode():
        with _Patched([(poolers, "roi_align_multilevel", lambda _: recording_entry(poolers, recorded, 1))]):
            t0 = time.perf_counter()
            det = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        det = model(batch)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: c.launches for k, c in kernel_counters().items()}
    check(counts == {"B1": 2, "B2": 0, "B3": 0, "B4": 0}, f"{label}: launches {counts}")
    check_cse(det["pred_densepose_embedding"], det["pred_densepose_fg"], B, K, E)
    check(det["pred_densepose_embedding"].shape[1] == D and min(det["valid"].sum(1).tolist()) > 0,
          tuple(det["pred_densepose_embedding"].shape))
    fg = det["pred_densepose_fg"][:, :K].float().mean().item()
    log(f"  {label} batch forward {B}x{H}x{W}: first {first_ms:.1f} ms, then {batch_ms:.1f} ms "
        f"({B / batch_ms * 1e3:.2f} img/s); peak memory {peak:.2f} GiB; pred_densepose_embedding "
        f"{tuple(det['pred_densepose_embedding'].shape)} ({K} of {D} slots run), foreground share {fg:.3f}; B1 launches 2")
    del det
    with torch.inference_mode():
        out["pools"] = compare_pools(recorded, ["box"], label)
    out.update(batch_ms=batch_ms, first_batch_ms=first_ms, img_s=B / batch_ms * 1e3, peak_gib=peak,
               launches=request_launches + counts["B1"])
    return out


def cse_trainer(name: str, features: dict, workdir: str, iters: int):
    """The DensePose Trainer of a CSE yaml with the smoke run's cuts
    (``densepose_train``'s) and FrozenBN calibrated on 4 train images."""
    from detectron2_tpu_torch.projects.densepose import Trainer

    class SmokeTrainer(Trainer):
        def build_writers(self):
            return []

    cfg = cse_cfg(name, features, ["SOLVER.MAX_ITER", str(iters), "SOLVER.WARMUP_ITERS", str(10 * TRAIN_STEPS),
                                   "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                                   "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0", "TEST.EVAL_PERIOD", "0",
                                   "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "OUTPUT_DIR", os.path.join(workdir, name)])
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    calibrate_densepose(trainer.model, cfg)
    return cfg, trainer


def cse_train(card: str, cfg, trainer, label: str, iters: int, cycle: str = "") -> dict:
    """``iters`` steps of ``trainer``; B1/B2 once a step (the box pool),
    held on the first batch; the losses finite, each mesh's embedding loss
    and ``cycle`` (a cycle loss) non-zero somewhere; the embedder's
    projections (and the DensePose head and predictor) moved; the
    evaluation after training (COCOEvaluator: the CSE DensePose metric is
    in neither package) one B1 launch a test image."""
    import torch

    heads = trainer.model.roi_heads
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
              if k.startswith(("roi_heads.densepose_", "roi_heads.decoder.", "roi_heads.embedder."))}
    check(any(".embedder." in k for k in before), f"{label}: no trainable embedder")
    recorded = []
    t_fwd = time.perf_counter()
    _, steps, train_s, peak = train_counted(trainer, recorded, 1)
    check(len(steps) == iters and all(s == (1, 1) for s in steps), f"{label}: per-step (B1, B2) launches {steps}")
    launches = (kernel_counters()["B1"].launches, kernel_counters()["B2"].launches)
    check(launches[0] == iters + CSE_TEST_IMAGES, f"{label}: B1 launches {launches[0]} (steps and evaluation)")
    hist = trainer.storage.histories()
    dp_losses = sorted(k for k in hist if k.startswith("loss_densepose_") or k in ("loss_shape2shape", "loss_pix2shape"))
    expect = {"loss_densepose_S"} | {f"loss_densepose_E_{m}" for m in heads.cse_mesh_names} | ({cycle} if cycle else set())
    check(set(dp_losses) == expect, (dp_losses, sorted(expect)))
    check_loss_values(trainer.storage, LOSSES[:2] + LOSSES[3:] + tuple(dp_losses), iters)
    nonzero = [k for k in dp_losses if any(v != 0 for v, _ in trainer.storage.history(k).values())]
    check(cycle in nonzero if cycle else True, f"{label}: {cycle} zero at every step")
    moved(trainer.model, {k: v for k, v in before.items() if ".embedder." not in k})
    moved_emb = [k for k, v in before.items() if ".embedder." in k and not torch.equal(trainer.model.get_parameter(k), v)]
    trained_meshes = {k.split(".")[2] for k in moved_emb}
    check(trained_meshes, f"{label}: no embedder projection moved")
    log(f"  {label}: {iters} steps at {cfg.SOLVER.IMS_PER_BATCH} images in {train_s:.2f} s; losses with a non-zero value "
        f"{nonzero}; the projections of {len(trained_meshes)} of {len(heads.cse_mesh_names)} meshes moved (those with "
        f"points in the steps); peak memory {peak:.2f} GiB; B1 {launches[0]}, B2 {launches[1]}")
    stats = step_times(trainer.storage, cfg.SOLVER.IMS_PER_BATCH, card, peak) if iters > 3 else {"train_s": train_s}
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-batch", keys=(BOX_RES,))
    return {**stats, "peak_gib": peak, "launches": launches, "fwd": fwd, "bwd": bwd,
            "wall_s": time.perf_counter() - t_fwd}


def cse_data() -> dict:
    """The synthetic CSE DensePose-COCO splits under the run's
    ``$DETECTRON2_DATASETS`` (CSE_IMAGES a train split, CSE_TEST_IMAGES in
    minival) and the SMPL mesh's files without its geodesics."""
    from detectron2_tpu_torch.testing import write_synthetic_cse_meshes, write_synthetic_densepose_cse

    root = os.environ["DETECTRON2_DATASETS"]
    t0 = time.perf_counter()
    write_synthetic_densepose_cse(root, CSE_IMAGES, seed=41, lvis_splits=(),
                                  coco_splits=("densepose_coco_2014_train_cse", "densepose_coco_2014_valminusminival_cse"))
    write_synthetic_densepose_cse(root, CSE_TEST_IMAGES, seed=42, lvis_splits=(), coco_splits=("densepose_coco_2014_minival_cse",))
    meshes = write_synthetic_cse_meshes(root, ["smpl_27554"], seed=41, geodists=False)
    return {"write_s": time.perf_counter() - t0, "features": {m: v["features"] for m, v in meshes.items() if m != "seconds"}}


def phase_densepose_cse(device, card: str, workdir: str):
    """Human CSE DensePose R-CNN at full width
    (``cse/densepose_rcnn_R_50_FPN_s1x.yaml``: the SMPL embedder, 27554
    vertices x 256 features projected to 16, ``EmbeddingLoss``) on the
    synthetic CSE DensePose-COCO (``densepose_coco_2014_*_cse``, flips
    through the synthetic SMPL symmetry table): 2 requests and a batch of 16
    x 800x1344 (B1 once a forward; the embeddings finite, the foreground
    boolean, the nearest vertices in range), then CSE_TRAIN_ITERS steps of
    ``densepose_train_net``'s Trainer at 16 images (B1/B2 once a step, held
    on the first batch; the losses finite; the embedder's projection moved).
    B3/B4 0 times."""
    import torch

    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights

    t_phase = time.perf_counter()
    data = cse_data()
    log(f"  synthetic CSE DensePose-COCO: {CSE_IMAGES} images in each train split, {CSE_TEST_IMAGES} in minival; the SMPL "
        f"mesh's files (27554 vertices, LBO features 27554 x 256) under $DETECTRON2_DATASETS, in {data['write_s']:.2f} s")
    cfg = cse_cfg("densepose_cse", data["features"], ["OUTPUT_DIR", os.path.join(workdir, "densepose_cse_inference")])
    cfg.defrost()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    predictor = DefaultPredictor(cfg, device=device)
    model = predictor.model
    emb = model.roi_heads.embedder.smpl_27554
    check(emb.features.abs().sum().item() > 0, "the SMPL embedder's features were not loaded from INIT_FILE")
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    init_weights(model, gen)
    with torch.no_grad():  # d2 starts the projection at zero: every vertex embedding would be 0
        emb.embeddings.normal_(0.0, 1.0, generator=gen)
    batch = noise_batch(device, B, H, W, 41)
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    inf = cse_inference(device, model, cfg, "human CSE R-CNN", batch, predictor)
    del model, predictor, batch
    free_card()
    cfg, trainer = cse_trainer("densepose_cse", data["features"], workdir, CSE_TRAIN_ITERS)
    train = cse_train(card, cfg, trainer, "human CSE R-CNN", CSE_TRAIN_ITERS)
    del trainer
    free_card()
    res = {"densepose_cse_write_s": data["write_s"], **backbone_result("densepose_cse", inf, train),
           "densepose_cse_phase_s": time.perf_counter() - t_phase}
    res.update(b1_launches=inf["launches"] + train["launches"][0], b2_launches=train["launches"][1],
               pools={"densepose_cse": (inf["pools"], DENSEPOSE_PER["densepose_cse"])},
               train_fwd={"densepose_cse": (train["fwd"], DENSEPOSE_PER["densepose_cse_train"])},
               train_bwd={"densepose_cse": (train["bwd"], DENSEPOSE_PER["densepose_cse_train"])})
    return res


def animals_data(device) -> dict:
    """The synthetic DensePose-LVIS ds1 and ds2 splits (CSE_IMAGES a train
    split, CSE_TEST_IMAGES a val split) and the files of the animal meshes
    of the 4k, i2m and m2m configs with their geodesics, computed on the
    card."""
    from detectron2_tpu_torch.testing import write_synthetic_cse_meshes, write_synthetic_densepose_cse

    root = os.environ["DETECTRON2_DATASETS"]
    t0 = time.perf_counter()
    write_synthetic_densepose_cse(root, CSE_IMAGES, seed=43, coco_splits=(),
                                  lvis_splits=("densepose_lvis_v1_ds1_train_v1", "densepose_lvis_v1_ds2_train_v1"))
    write_synthetic_densepose_cse(root, CSE_TEST_IMAGES, seed=44, coco_splits=(),
                                  lvis_splits=("densepose_lvis_v1_ds1_val_v1", "densepose_lvis_v1_ds2_val_v1"))
    data_s = time.perf_counter() - t0
    meshes = write_synthetic_cse_meshes(root, sorted(set(ANIMAL_MESHES) | set(I0_MESHES)), seed=43, device=str(device))
    features = {m: v["features"] for m, v in meshes.items() if m != "seconds"}
    gib = sum(os.path.getsize(v["geodists"]) for m, v in meshes.items() if m != "seconds") / 2**30
    return {"data_s": data_s, "meshes_s": meshes["seconds"], "geodists_gib": gib, "features": features}


def phase_densepose_animals(device, card: str, workdir: str):
    """Animal CSE DensePose R-CNN at full width on a synthetic DensePose-LVIS
    (``densepose_lvis_v1_*``): the 4k yaml (9 classes, 9 meshes of 4936-5004
    vertices, ``SoftEmbeddingLoss`` with the meshes' geodesics,
    ``COARSE_SEGM_TRAINED_BY_MASKS``): a batch of 16 x 800x1344, then
    ANIMALS_TRAIN_ITERS steps at 16 images, its classes 0..8 through
    ``WHITELISTED_CATEGORIES`` (correction 17) in the order of its
    ``CLASS_TO_MESH_NAME_MAPPING``; then CYCLE_TRAIN_ITERS steps each of the
    i2m yaml (the pixel-to-shape loss) and the m2m yaml (the shape-to-shape
    loss, ten meshes, SMPL among them: its 3 GB geodesics computed on the
    card and written for this phase, then removed), each cycle loss finite
    and non-zero. B1/B2 once a step, held on each config's first batch;
    B3/B4 0 times."""
    import torch

    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.projects.densepose import densepose_dataset_dicts
    from detectron2_tpu_torch.testing import write_synthetic_cse_meshes

    t_phase = time.perf_counter()
    data = animals_data(device)
    log(f"  synthetic DensePose-LVIS: ds1 and ds2, {CSE_IMAGES} train and {CSE_TEST_IMAGES} val images each, in "
        f"{data['data_s']:.2f} s; {len(data['features'])} animal meshes (their geodesics {data['geodists_gib']:.2f} GiB, "
        f"computed on the card) in {data['meshes_s']:.2f} s")
    res = {"densepose_animals_write_s": data["data_s"], "densepose_animals_meshes_s": data["meshes_s"]}
    pools, train_fwd, train_bwd = {}, {}, {}
    b1 = b2 = 0

    cfg, trainer = cse_trainer("densepose_animals", data["features"], workdir, ANIMALS_TRAIN_ITERS)
    name = cfg.DATASETS.TRAIN[0]
    classes = sorted({a["category_id"] for d in densepose_dataset_dicts(cfg, [name]) for a in d["annotations"]})
    thing = MetadataCatalog.get(name).thing_classes
    mapping = cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING
    check(classes and min(classes) >= 0 and max(classes) <= 8 and len(thing) == 9
          and [mapping[str(c)].split("_")[0] for c in range(9)] == thing, (classes, thing))
    log(f"  {name}: classes {classes} of {thing} (the whitelist sorted; CLASS_TO_MESH_NAME_MAPPING's order)")
    batch = noise_batch(device, B, H, W, 42)
    inf = cse_inference(device, trainer.model, cfg, "animal CSE R-CNN", batch)
    del batch
    trainer.model.train()
    train = cse_train(card, cfg, trainer, "animal CSE R-CNN (4k)", ANIMALS_TRAIN_ITERS)
    del trainer
    free_card()
    res.update(backbone_result("densepose_animals", inf, train))
    pools["densepose_animals"] = (inf["pools"], DENSEPOSE_PER["densepose_animals"])
    train_fwd["densepose_animals"] = (train["fwd"], DENSEPOSE_PER["densepose_animals_train"])
    train_bwd["densepose_animals"] = (train["bwd"], DENSEPOSE_PER["densepose_animals_train"])
    b1 += inf["launches"] + train["launches"][0]
    b2 += train["launches"][1]

    root = os.environ["DETECTRON2_DATASETS"]
    for name, label, cycle in (("densepose_i2m", "animal CSE R-CNN i2m", "loss_pix2shape"),
                               ("densepose_m2m", "animal CSE R-CNN m2m", "loss_shape2shape")):
        features = dict(data["features"])
        smpl = None
        if name == "densepose_m2m":
            smpl = write_synthetic_cse_meshes(root, ["smpl_27554"], seed=41, device=str(device))
            gib = os.path.getsize(smpl["smpl_27554"]["geodists"]) / 2**30
            log(f"  the SMPL mesh's geodesics (27554 x 27554 float32, {gib:.2f} GiB) computed on the card and written in "
                f"{smpl['seconds']:.2f} s")
            res["densepose_m2m_smpl_geodists_s"] = smpl["seconds"]
            features["smpl_27554"] = smpl["smpl_27554"]["features"]
        try:
            cfg, trainer = cse_trainer(name, features, workdir, CYCLE_TRAIN_ITERS)
            train = cse_train(card, cfg, trainer, label, CYCLE_TRAIN_ITERS, cycle)
            del trainer
        finally:
            if smpl is not None:
                os.remove(smpl["smpl_27554"]["geodists"])
        free_card()
        res.update(backbone_result(name, None, train))
        train_fwd[name] = (train["fwd"], DENSEPOSE_PER[f"{name}_train"])
        train_bwd[name] = (train["bwd"], DENSEPOSE_PER[f"{name}_train"])
        b1 += train["launches"][0]
        b2 += train["launches"][1]
    res.update(densepose_animals_phase_s=time.perf_counter() - t_phase, b1_launches=b1, b2_launches=b2, pools=pools,
               train_fwd=train_fwd, train_bwd=train_bwd)
    return res


DCONV_DENSEPOSE_NAMES = {39: "dconv", 40: "densepose", 41: "densepose_cse", 42: "densepose_animals"}
DCONV_DENSEPOSE_KEYS = ("dconv_", "densepose")


def run_dconv_densepose_phases(timed, device, card: str, workdir: str, coco, phases=(39, 40, 41, 42)) -> dict:
    titles = {
        39: ("deformable conv: dconv R50-FPN requests, batch forward, the op vs float64, DefaultTrainer; "
             "panoptic R101 dconv", phase_dconv, (device, card, workdir, coco)),
        40: ("DensePose R-CNN: the decoder config's requests, batch forward, densepose_train_net and --eval-only with "
             "the DensePose evaluator; _legacy; DL_WC1", phase_densepose, (device, card, workdir)),
        41: ("human CSE DensePose R-CNN: requests, batch forward and densepose_train_net", phase_densepose_cse,
             (device, card, workdir)),
        42: ("animal CSE DensePose R-CNN: the 4k config's batch forward and training (soft loss, masks, DensePose-LVIS); "
             "i2m and m2m cycle losses", phase_densepose_animals, (device, card, workdir)),
    }
    out = {}
    for n in phases:
        with attention_free(f"phase {n}"):
            out[n] = timed(n, titles[n][0], titles[n][1], *titles[n][2])
    return out


def dconv_densepose_entries(results: dict, kind: str) -> dict:
    """Phases 39-40's pools in the kernels line, one entry a path."""
    out = {}
    for r in results.values():
        if kind == "fwd":
            out.update({name: pools_entry(p, per) for name, (p, per) in r["pools"].items()})
        out.update({f"{name}_train": pools_entry(p, ("backward of " if kind == "bwd" else "") + per)
                    for name, (p, per) in r["train_" + kind].items()})
    return out


def dconv_densepose_pools(results: dict, kind: str) -> list:
    out = [p for r in results.values() for p, _ in r["train_" + kind].values()]
    return out + ([p for r in results.values() for p, _ in r["pools"].values()] if kind == "fwd" else [])


# ---------------------------------------------------------------- phases 43-44
# HRNet + HRFPN DensePose R-CNN (its box head pools from five levels, p1-p5 at
# strides 4-64) and bootstrap training on the evolution config (the bootstrap
# model's pseudo-labels mixed into the ground truth)
DENSEPOSE_CONFIGS.update({
    "densepose_hrfpn_w32": "DensePose/densepose_rcnn_HRFPN_HRNet_w32_s1x.yaml",
    "densepose_hrfpn_w48": "DensePose/densepose_rcnn_HRFPN_HRNet_w48_s1x.yaml",
})
EVOLUTION_CONFIG = "DensePose/evolution/densepose_R_50_FPN_DL_WC1M_3x_Atop10P_CA_B_uniform.yaml"
HRFPN_LEVELS = 5
# the smoke run's cuts (PERF.md section 4): 3 steps of each at its 16 images;
# 16 synthetic COCO 2017 images for base_coco_2017_train, 8 unlabelled PNGs
# for the bootstrap list; the bootstrap model keeps BOOTSTRAP_DETECTIONS
# detections an image (seeded weights pass every one of them through the
# lowered filter, and the host samplers take ~0.2 s a detection)
HRFPN_TRAIN_ITERS = BOOTSTRAP_TRAIN_ITERS = 3
BASE_COCO_IMAGES, BOOTSTRAP_IMAGES, BOOTSTRAP_DETECTIONS = 16, 8, 4
BOOTSTRAP_DATASET = "chip_smoke_bootstrap_images"
HRFPN_BOOTSTRAP_NAMES = {43: "densepose_hrfpn", 44: "densepose_bootstrap"}
HRFPN_BOOTSTRAP_KEYS = ("densepose_hrfpn", "densepose_bootstrap")
DENSEPOSE_PER.update({
    "densepose_hrfpn_w32": "5-level box pool (p1-p5, strides 4-64) of one 16x800x1344 HRFPN-w32 DensePose R-CNN forward",
    "densepose_hrfpn_w48": "5-level box pool of one 16x800x1344 HRFPN-w48 DensePose R-CNN forward",
    "densepose_hrfpn_w32_train": "5-level box pool of the HRFPN-w32 config's first 16-image batch",
    "densepose_bootstrap_model": "box pool (p2-p5) of the bootstrap model's first pseudo-labelling forward (one image)",
    "densepose_bootstrap_train": "box pool of the evolution config's first mixed 16-image batch",
})


def calibrate_norms(model, batch) -> None:
    """``modeling.calibrate_frozen_bn``'s rule for FrozenBN and BN alike:
    each norm's running statistics set to its input's per-channel mean and
    (biased) variance on ``batch``, in forward order (seeded BN keeps
    identity statistics, which blow a deep trunk's activations up in eval)."""
    from detectron2_tpu_torch.layers import BatchNorm2d, FrozenBatchNorm2d

    def set_stats(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(set_stats) for m in model.modules()
               if isinstance(m, (FrozenBatchNorm2d, BatchNorm2d))]
    try:
        model(batch)
    finally:
        for h in handles:
            h.remove()


def hrfpn_golden(device) -> float:
    """HRNet + HRFPN on the card in float32 against the d2 golden
    (``tests/goldens/hrfpn_backbone.npz``, its weights loaded by d2 name),
    within 5e-3 (``tests/parity/test_hrfpn_backbone_golden.py``'s bound)."""
    import torch

    from detectron2_tpu_torch.checkpoint import load_state_dict_report
    from detectron2_tpu_torch.config import get_cfg
    from detectron2_tpu_torch.modeling.backbone import build_backbone
    from detectron2_tpu_torch.projects.densepose import add_densepose_config
    from detectron2_tpu_torch.testing import golden_state_dict

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "hrfpn_backbone.npz"))
    cfg = get_cfg()
    add_densepose_config(cfg)
    h = cfg.MODEL.HRNET
    for k, stage in enumerate((h.STAGE2, h.STAGE3, h.STAGE4), start=2):
        stage.NUM_MODULES, stage.NUM_BLOCKS, stage.NUM_CHANNELS = (2 if k == 3 else 1), [2] * k, [16 * 2**i for i in range(k)]
    h.HRFPN.OUT_CHANNELS = 64
    cfg.MODEL.BACKBONE.NAME = "build_hrfpn_backbone"
    cfg.MODEL.ROI_HEADS.IN_FEATURES = [f"p{i + 1}" for i in range(HRFPN_LEVELS)]
    model = build_backbone(cfg).to(device).eval()
    report = load_state_dict_report(model, golden_state_dict(golden))
    check(report.splitlines()[0] == f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint.",
          report)
    with torch.inference_mode():
        out = model(torch.from_numpy(golden["image"][None].astype(np.float32)).to(device))
    torch.cuda.synchronize()
    errs = {}
    for i in range(HRFPN_LEVELS):
        ref = golden[f"feat_p{i + 1}"].transpose(0, 2, 3, 1)
        got = out[f"p{i + 1}"].float().cpu().numpy()
        check(got.shape == ref.shape, (i, got.shape, ref.shape))
        errs[f"p{i + 1}"] = float(np.abs(got - ref).max())
    check(max(errs.values()) < 5e-3, f"HRFPN golden: {errs}")
    log(f"  HRNet + HRFPN golden on the card, f32, weights by d2 name: max |err| per level {errs} (bound 5e-3)")
    return max(errs.values())


def step_timer(trainer, started: list, step_s: list) -> None:
    """Each step's seconds, from before its loader read to its end (a
    synchronised card), by a hook run before the trainer's own hooks (the
    final checkpoint is not in the last step)."""
    import torch

    from detectron2_tpu_torch.engine import hooks

    def after(_):
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - started[-1])

    trainer.register_hooks([hooks.CallbackHook(before_step=lambda t: started.append(time.perf_counter()), after_step=after)])
    trainer._hooks.insert(0, trainer._hooks.pop())


def step_summary(storage, step_s: list, ims: int, card: str, label: str) -> dict:
    """Median step and data_time of steps 2 on (the first meets cold
    caches), img/s and the loader's share of those steps."""
    data = [v for v, _ in storage.history("data_time").values()][1:]
    step_ms, data_ms = float(np.median(step_s[1:])) * 1e3, float(np.median(data)) * 1e3
    share = sum(data) / sum(step_s[1:])
    log(f"  {card}: {label} steps 2-{len(step_s)}: median step {step_ms:.1f} ms, median data_time {data_ms:.1f} ms "
        f"({share:.1%} of the step), {ims / step_ms * 1e3:.2f} img/s")
    log("  step times (ms): " + ", ".join(f"{s * 1e3:.1f}" for s in step_s) + "; data times (ms): "
        + ", ".join(f"{v * 1e3:.1f}" for v, _ in storage.history("data_time").values()))
    return {"ms_per_step": step_ms, "data_ms_per_step": data_ms, "img_s": ims / step_ms * 1e3, "data_share": share}


def hrfpn_train(device, card: str, workdir: str) -> dict:
    """``densepose_train_net``'s setup and Trainer of the HRFPN-w32 yaml on
    the synthetic DensePose-COCO at its 16 images (640-800 / 1333, flips)
    for HRFPN_TRAIN_ITERS steps: seeded weights, every BN on the batch's
    statistics (no calibration needed), gradients clipped to a global norm
    of 1 as the yaml has it, warmup over 100, no evaluation (the smoke run's
    cuts). B1/B2 once a step (the 5-level box pool), held on the first
    batch; finite losses; the backbone's, HRFPN's and the DensePose heads'
    tensors moved."""
    import torch

    from detectron2_tpu_torch.projects.densepose import Trainer

    class SmokeTrainer(Trainer):
        def build_writers(self):
            return []

    name, label = "densepose_hrfpn_w32", "HRFPN-w32 DensePose R-CNN"
    cfg = densepose_cfg(name, ["SOLVER.MAX_ITER", str(HRFPN_TRAIN_ITERS), "SOLVER.WARMUP_ITERS", str(10 * TRAIN_STEPS),
                               "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", os.path.join(workdir, name)])
    check((cfg.SOLVER.CLIP_GRADIENTS.ENABLED, cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE, cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE)
          == (True, "norm", 1.0), f"{label}: the yaml's gradient clipping")
    cfg.defrost()
    cfg.DATASETS.TEST = ()  # no evaluation after training (the smoke run's cut)
    cfg.freeze()
    trainer = SmokeTrainer(cfg)
    trainer.resume_or_load(resume=False)
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
              if k.startswith(("roi_heads.densepose_", "roi_heads.decoder.", "backbone.interp_conv", "backbone.fpn_conv",
                               "backbone.bottom_up.stage4"))}
    started, step_s, recorded = [], [], []
    step_timer(trainer, started, step_s)
    _, steps, train_s, peak = train_counted(trainer, recorded, 1)
    check(steps == [(1, 1)] * HRFPN_TRAIN_ITERS, f"{label}: per-step (B1, B2) launches {steps}")
    launches = (kernel_counters()["B1"].launches, kernel_counters()["B2"].launches)
    dp_losses = sorted(k for k in trainer.storage.histories() if k.startswith("loss_densepose_"))
    check(len(dp_losses) == 4, dp_losses)
    check_loss_values(trainer.storage, LOSSES[:2] + LOSSES[3:] + tuple(dp_losses), HRFPN_TRAIN_ITERS)
    moved(trainer.model, before)
    levels = [tuple(f.shape[1:3]) for f in recorded[0]["args"][0]]
    check(len(levels) == HRFPN_LEVELS, f"{label}: the box pool's levels {levels}")
    ims = trainer.cfg.SOLVER.IMS_PER_BATCH
    log(f"  {label}: {HRFPN_TRAIN_ITERS} steps at {ims} images in {train_s:.2f} s; the {len(before)} "
        f"DensePose head, decoder, HRFPN and stage-4 tensors moved; peak memory {peak:.2f} GiB; B1 {launches[0]}, "
        f"B2 {launches[1]}; box pool levels {levels}")
    stats = step_summary(trainer.storage, step_s, ims, card, label)
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-batch", keys=("box",))
    del trainer
    free_card()
    return {**stats, "peak_gib": peak, "train_s": train_s, "launches": launches, "fwd": fwd, "bwd": bwd}


def phase_densepose_hrfpn(device, card: str, workdir: str):
    """HRNet + HRFPN DensePose R-CNN through ``densepose_train_net``'s setup
    (bf16, seeded weights, every BN calibrated on two noise images, score
    threshold 0): the HRFPN backbone against its d2 golden in float32; the
    ``_w32_s1x`` yaml's 2 requests and a batch forward at 16 x 800x1344 (B1
    once a forward, the box pool over p1-p5) and HRFPN_TRAIN_ITERS steps at
    its 16 images (B2 once a step); one batch forward of the ``_w48`` yaml.
    B1/B2 held to their plain versions on the recorded 5-level pools; B3/B4
    0 times."""
    t_phase = time.perf_counter()
    root = os.environ["DETECTRON2_DATASETS"]
    if not os.path.exists(os.path.join(root, "coco", "annotations", "densepose_train2014.json")):
        data = densepose_data()
        log(f"  synthetic DensePose-COCO: {DENSEPOSE_IMAGES} images a train split, written in {data['write_s']:.2f} s")
    res = {"densepose_hrfpn_golden_max_abs_err": hrfpn_golden(device)}
    pools, train_fwd, train_bwd = {}, {}, {}
    w32 = densepose_inference(device, workdir, "densepose_hrfpn_w32", "HRFPN-w32 DensePose R-CNN", True, levels=HRFPN_LEVELS)
    train = hrfpn_train(device, card, workdir)
    w48 = densepose_inference(device, workdir, "densepose_hrfpn_w48", "HRFPN-w48 DensePose R-CNN", False, levels=HRFPN_LEVELS)
    res.update(backbone_result("densepose_hrfpn_w32", w32, train))
    res.update(backbone_result("densepose_hrfpn_w48", w48))
    pools["densepose_hrfpn_w32"] = (w32["pools"], DENSEPOSE_PER["densepose_hrfpn_w32"])
    pools["densepose_hrfpn_w48"] = (w48["pools"], DENSEPOSE_PER["densepose_hrfpn_w48"])
    train_fwd["densepose_hrfpn_w32"] = (train["fwd"], DENSEPOSE_PER["densepose_hrfpn_w32_train"])
    train_bwd["densepose_hrfpn_w32"] = (train["bwd"], DENSEPOSE_PER["densepose_hrfpn_w32_train"])
    res.update(densepose_hrfpn_phase_s=time.perf_counter() - t_phase,
               b1_launches=w32["launches"] + train["launches"][0] + w48["launches"], b2_launches=train["launches"][1],
               pools=pools, train_fwd=train_fwd, train_bwd=train_bwd)
    return res


def bootstrap_data(workdir: str) -> dict:
    """The evolution config's ground truth under the builtin names (COCO
    2017's instances for ``base_coco_2017_train``, from
    ``testing.write_synthetic_coco``, raw category ids: the 80 things, some
    of them 1 and 16-25, which the yaml whitelists and maps onto person;
    the DensePose-COCO train split) and BOOTSTRAP_IMAGES unlabelled PNGs
    registered as the image list ``BOOTSTRAP_DATASET`` (category
    ``chimpanzee``): ChimpnSee's videos are downloads, and PyAV is not on
    the card's machine."""
    from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from detectron2_tpu_torch.projects.densepose.build import DatasetType
    from detectron2_tpu_torch.testing import write_synthetic_coco

    root = os.environ["DETECTRON2_DATASETS"]
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(root, "coco", "annotations", "densepose_train2014.json")):
        densepose_data()
    json_file, image_root = write_synthetic_coco(os.path.join(workdir, "base_coco"), BASE_COCO_IMAGES, seed=44)
    # into COCO 2017's folders beside the panoptic tree of phases 32-33, under
    # names of their own
    with open(json_file) as f:
        coco = json.load(f)
    for folder in ("annotations", "train2017"):
        os.makedirs(os.path.join(root, "coco", folder), exist_ok=True)
    for im in coco["images"]:
        name = "base_" + im["file_name"]
        os.replace(os.path.join(image_root, im["file_name"]), os.path.join(root, "coco", "train2017", name))
        im["file_name"] = name
    with open(os.path.join(root, "coco", "annotations", "instances_train2017.json"), "w") as f:
        json.dump(coco, f)
    _, list_root = write_synthetic_coco(os.path.join(workdir, "bootstrap"), BOOTSTRAP_IMAGES, seed=45,
                                        sizes=((480, 640), (427, 640)))
    list_file = os.path.join(workdir, "bootstrap", "images.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(sorted(p for p in os.listdir(list_root) if p.endswith(".png"))) + "\n")
    DatasetCatalog.register(BOOTSTRAP_DATASET, lambda: [])
    MetadataCatalog.get(BOOTSTRAP_DATASET).set(dataset_type=DatasetType.IMAGE_LIST, image_list_fpath=list_file,
                                               image_base_path=list_root, category="chimpanzee")
    return {"write_s": time.perf_counter() - t0}


def evolution_cfg(workdir: str):
    """``densepose_train_net.setup`` of the evolution yaml in bf16 with
    ``MODEL.WEIGHTS`` and ``BOOTSTRAP_MODEL.WEIGHTS`` cleared (downloads:
    seeded weights), SEED 44, checked as the zoo has it; then the smoke
    run's overrides, each logged: the bootstrap dataset is the image list
    (``IMAGE_LOADER.TYPE image_list``), ``FILTER.MIN_VALUE`` 0.0 (seeded
    scores stay under the yaml's 0.8), BOOTSTRAP_DETECTIONS detections an
    image, BOOTSTRAP_TRAIN_ITERS steps, warmup over 100, the yaml's gradient
    clipping by global norm (1.0) for by value (seeded weights diverge
    under the latter, as phase 40's yamls do), no evaluation."""
    from detectron2_tpu_torch.engine import default_argument_parser
    from detectron2_tpu_torch.tools import densepose_train_net as tool

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", EVOLUTION_CONFIG)
    args = default_argument_parser().parse_args(
        ["--config-file", path, "MODEL.WEIGHTS", "", "BOOTSTRAP_MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE", "bfloat16",
         "SEED", "44", "SOLVER.MAX_ITER", str(BOOTSTRAP_TRAIN_ITERS), "SOLVER.WARMUP_ITERS", str(10 * TRAIN_STEPS),
         "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0",
         "TEST.EVAL_PERIOD", "0", "OUTPUT_DIR", os.path.join(workdir, "densepose_bootstrap")]
    )
    cfg = tool.setup(args)
    h, (spec,) = cfg.MODEL.ROI_DENSEPOSE_HEAD, cfg.BOOTSTRAP_DATASETS
    check((cfg.MODEL.ROI_HEADS.NAME, cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.SOLVER.IMS_PER_BATCH, cfg.DATASETS.TRAIN, h.NAME,
           h.UV_CONFIDENCE.TYPE, h.SEGM_CONFIDENCE.ENABLED, cfg.SOLVER.CLIP_GRADIENTS.ENABLED, dict(cfg.DATASETS.WHITELISTED_CATEGORIES),
           spec["DATASET"], spec["RATIO"], spec["IMAGE_LOADER"]["TYPE"], spec["IMAGE_LOADER"]["BATCH_SIZE"], spec["INFERENCE"],
           spec["DATA_SAMPLER"], spec["FILTER"])
          == ("DensePoseROIHeads", 1, 16, ("base_coco_2017_train", "densepose_coco_2014_train"), "DensePoseDeepLabHead",
              "iid_iso", True, True, {"base_coco_2017_train": [1] + list(range(16, 26)), "base_coco_2017_val": [1] + list(range(16, 26))},
              "chimpnsee", 1.0, "video_keyframe", 8, {"INPUT_BATCH_SIZE": 1, "OUTPUT_BATCH_SIZE": 1},
              {"TYPE": "densepose_uniform", "COUNT_PER_CLASS": 8}, {"TYPE": "detection_score", "MIN_VALUE": 0.8}),
          f"{EVOLUTION_CONFIG} as the zoo has it")
    # the yaml's list of dicts stays mutable in the frozen config
    spec["DATASET"], spec["IMAGE_LOADER"]["TYPE"], spec["FILTER"]["MIN_VALUE"] = BOOTSTRAP_DATASET, "image_list", 0.0
    cfg.defrost()
    cfg.TEST.DETECTIONS_PER_IMAGE = BOOTSTRAP_DETECTIONS
    cfg.DATASETS.TEST = ()
    cfg.freeze()
    log(f"  overrides: BOOTSTRAP_DATASETS[0].DATASET {BOOTSTRAP_DATASET} with IMAGE_LOADER.TYPE image_list (for chimpnsee's "
        f"video_keyframe), FILTER.MIN_VALUE 0.0 (for 0.8), TEST.DETECTIONS_PER_IMAGE {BOOTSTRAP_DETECTIONS} (for 100), "
        f"DATASETS.TEST () (for densepose_chimps); weights seeded (SEED 44), FrozenBN calibrated")
    return cfg


def phase_densepose_bootstrap(device, card: str, workdir: str):
    """Bootstrap training on the evolution yaml through
    ``densepose_train_net``'s Trainer (bf16): the bootstrap model (seeded,
    FrozenBN calibrated on its first batch) pseudo-labels the image list,
    its samples mixed 1:1 into ``base_coco_2017_train`` +
    ``densepose_coco_2014_train`` by ``CombinedDataLoader`` and collated
    into one padded batch; BOOTSTRAP_TRAIN_ITERS steps at 16 images.
    Checks: pseudo-labelled instances (``batch/<dataset>``) at every step;
    each pseudo sample's points inside its boxes, parts in 1..24, U/V in
    [0, 1]; the whitelisted COCO 2017 classes made person; B1 once a
    bootstrap forward and once a train step, B2 once a step, held to their
    plain versions on a recorded bootstrap pool and the first train step's;
    finite losses, the DensePose heads moved. Measures the bootstrap
    inference per image, the step and its data_time."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import hooks
    from detectron2_tpu_torch.projects.densepose import Trainer, SampleCountMetricPrinter
    from detectron2_tpu_torch.projects.densepose import build as dp_build
    from detectron2_tpu_torch.projects.densepose import trainer as dp_trainer
    from detectron2_tpu_torch.projects.densepose.datasets import densepose_dataset_dicts

    t_phase = time.perf_counter()
    data = bootstrap_data(workdir)
    cfg = evolution_cfg(workdir)
    gt = densepose_dataset_dicts(cfg, cfg.DATASETS.TRAIN)
    classes = [a["category_id"] for d in gt for a in d["annotations"]]
    n_base = sum(os.path.basename(d["file_name"]).startswith("base_") for d in gt)
    check(n_base > 0 and set(classes) == {0}, f"the ground truth: {n_base} COCO 2017 images, classes {sorted(set(classes))}")
    log(f"  ground truth and image list written in {data['write_s']:.2f} s: {len(gt)} train images ({n_base} of COCO 2017 "
        f"with a whitelisted category), {len(classes)} instances, all class 0 (person)")

    fwd_k, bwd_k = kernel_counters()["B1"], kernel_counters()["B2"]
    boot = {"calls": 0, "images": 0, "s": 0.0, "b1": 0, "dets": 0}
    packed, recorded_boot, recorded = [], [], []

    def timed_predictor(build):
        def make(cfg, model=None):
            predict = build(cfg, model)

            def timed(batch):
                torch.cuda.synchronize()
                l0, t0 = fwd_k.launches, time.perf_counter()
                out = predict(batch)  # host numpy: synchronised
                boot["s"] += time.perf_counter() - t0
                boot["b1"] += fwd_k.launches - l0
                boot["calls"] += 1
                boot["images"] += len(batch)
                boot["dets"] += sum(len(o["instances"]) for o in out)
                return out
            return timed
        return make

    def recording_packing(pack):
        def rec(sample, *args, **kwargs):
            out = pack(sample, *args, **kwargs)
            packed.append(out["instances"])
            return out
        return rec

    def recording_both(entry):
        """The first bootstrap pool (no gradient) and the first train pool
        (its cotangent too)."""
        def rec(*args, **kwargs):
            out = entry(*args, **kwargs)
            if not out.requires_grad:
                if not recorded_boot:
                    recorded_boot.append((args, kwargs))
            elif not recorded:
                r = {"args": args, "kwargs": kwargs}
                out.register_hook(lambda g: r.__setitem__("grad", g.detach().clone(memory_format=torch.contiguous_format)))
                recorded.append(r)
            return out
        return rec

    class SmokeTrainer(Trainer):
        def build_writers(self):
            return [SampleCountMetricPrinter()]

    with _Patched([(dp_trainer, "build_bootstrap_predictor", timed_predictor),
                   (dp_build, "pseudo_to_train_sample", recording_packing)]):
        trainer = SmokeTrainer(cfg)
        trainer.resume_or_load(resume=False)
        calibrate_on_train_images(trainer.model, cfg, "densepose_coco_2014_train")
        before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()
                  if k.startswith(("roi_heads.densepose_", "roi_heads.decoder."))}
        per_step, per_step_boot, started, step_s = [], [], [], []
        trainer.register_hooks([hooks.CallbackHook(
            after_step=lambda t: (per_step.append((fwd_k.launches, bwd_k.launches)), per_step_boot.append(boot["b1"])))])
        step_timer(trainer, started, step_s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_launches()
        fwd_k.paths = {}
        t0 = time.perf_counter()
        with _Patched([(poolers, "roi_align_multilevel", recording_both)]):
            trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (fwd_k.launches, bwd_k.launches)
    steps = step_launches(per_step)
    boot_steps = [b - p for b, p in zip(per_step_boot, [0] + per_step_boot[:-1])]
    # the bootstrap model's first call calibrates its FrozenBN (one forward more)
    check(boot["b1"] == boot["calls"] + 1 and boot["images"] == boot["calls"], boot)
    check([s for s in steps] == [(1 + b, 1) for b in boot_steps], f"per-step (B1, B2) {steps}, bootstrap B1 {boot_steps}")
    check(set(fwd_k.paths) <= {"vector"}, fwd_k.paths)
    counts = {k: [v for v, _ in h.values()] for k, h in trainer.storage.histories().items() if k.startswith("batch/")}
    check(len(counts.get(f"batch/{BOOTSTRAP_DATASET}", [])) == BOOTSTRAP_TRAIN_ITERS
          and min(counts[f"batch/{BOOTSTRAP_DATASET}"]) > 0, f"pseudo-labelled instances a step {counts}")
    n_pts = 0
    for inst in packed:
        boxes = inst.gt_boxes.tensor.numpy()
        part, pts = inst.gt_dp_part, inst.gt_dp_points
        on = part >= 0
        n_pts += int(on.sum())
        check(((part[on] >= 1) & (part[on] <= 24)).all(), "pseudo-label parts")
        check(((inst.gt_dp_u[on] >= 0) & (inst.gt_dp_u[on] <= 1) & (inst.gt_dp_v[on] >= 0) & (inst.gt_dp_v[on] <= 1)).all(),
              "pseudo-label U/V")
        lo, hi = np.broadcast_to(boxes[:, None, :2], pts.shape)[on], np.broadcast_to(boxes[:, None, 2:], pts.shape)[on]
        check(((pts[on] >= lo - 1e-3) & (pts[on] <= hi + 1e-3)).all(), "pseudo-label points outside their boxes")
    check(n_pts > 0, "no pseudo-labelled point")
    dp_losses = sorted(k for k in trainer.storage.histories() if k.startswith("loss_densepose_"))
    check(len(dp_losses) == 3, dp_losses)
    check_loss_values(trainer.storage, ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc") + tuple(dp_losses),
                      BOOTSTRAP_TRAIN_ITERS)
    moved(trainer.model, before)
    ms_img = boot["s"] / boot["images"] * 1e3
    log(f"  bootstrap: {boot['images']} images pseudo-labelled in {boot['calls']} forwards, {boot['dets']} detections, "
        f"{len(packed)} samples packed with {n_pts} points; {card}: {ms_img:.1f} ms an image (forward, host copy and "
        f"unpadding; the samplers run after); instances a step {counts}")
    ims = trainer.cfg.SOLVER.IMS_PER_BATCH
    log(f"  bootstrap training: {BOOTSTRAP_TRAIN_ITERS} steps at {ims} images in {train_s:.2f} s; the "
        f"{len(before)} DensePose head and decoder tensors moved; peak memory {peak:.2f} GiB; B1 {launches[0]} "
        f"({boot['b1']} by the bootstrap model), B2 {launches[1]}")
    stats = step_summary(trainer.storage, step_s, ims, card, "bootstrap training")
    with torch.inference_mode():
        boot_pools = compare_pools(recorded_boot, ["box"], "bootstrap model")
    fwd, bwd = compare_recorded_pools(recorded, "bootstrap training first-batch", keys=("box",))
    del trainer
    free_card()
    res = {f"densepose_bootstrap_train_{k}": v for k, v in stats.items()}
    res.update(densepose_bootstrap_ms_per_image=ms_img, densepose_bootstrap_images=boot["images"],
               densepose_bootstrap_model_b1_launches=boot["b1"], densepose_bootstrap_trainee_b1_launches=launches[0] - boot["b1"],
               densepose_bootstrap_train_peak_gib=peak, densepose_bootstrap_pseudo_instances=counts[f"batch/{BOOTSTRAP_DATASET}"],
               densepose_bootstrap_gt_instances=counts.get("batch/gt"), densepose_bootstrap_points=n_pts,
               densepose_bootstrap_phase_s=time.perf_counter() - t_phase,
               b1_launches=launches[0], b2_launches=launches[1],
               pools={"densepose_bootstrap_model": (boot_pools, DENSEPOSE_PER["densepose_bootstrap_model"])},
               train_fwd={"densepose_bootstrap": (fwd, DENSEPOSE_PER["densepose_bootstrap_train"])},
               train_bwd={"densepose_bootstrap": (bwd, DENSEPOSE_PER["densepose_bootstrap_train"])})
    return res


def run_hrfpn_bootstrap_phases(timed, device, card: str, workdir: str, phases=(43, 44)) -> dict:
    titles = {
        43: ("HRFPN DensePose R-CNN: the golden, the w32 yaml's requests, batch forward and training; the w48 yaml's "
             "batch forward", phase_densepose_hrfpn),
        44: ("DensePose bootstrap training on the evolution yaml (pseudo-labels mixed into the ground truth)",
             phase_densepose_bootstrap),
    }
    out = {}
    for n in phases:
        with attention_free(f"phase {n}"):
            out[n] = timed(n, titles[n][0], titles[n][1], device, card, workdir)
    return out


# ---------------------------------------------------------------- phase 45
# PointRend (standard, implicit, semantic) and PointSup: the box branch is
# the standard one (B1/B2), the PointRend mask branch samples points (no
# RoIAlign), PointSup's mask branch pools 14x14 (B1/B2 again); the semantic
# PointRend path launches none of B1-B4
POINTREND_CONFIGS = {
    "pointrend": "PointRend/pointrend_rcnn_R_50_FPN_3x_coco.yaml",
    "implicit_pointrend": "PointRend/implicit_pointrend_R_50_FPN_3x_coco.yaml",
    "semantic_pointrend": "PointRend/SemanticSegmentation/pointrend_semantic_R_101_FPN_1x_cityscapes.yaml",
    "point_sup": "PointSup/mask_rcnn_R_50_FPN_3x_point_sup_coco.yaml",
    "implicit_point_sup": "PointSup/implicit_pointrend_R_50_FPN_3x_point_sup_point_aug_coco.yaml",
}
# the smoke run's cuts (PERF.md section 4): 3 and 2 DefaultTrainer steps at
# the yamls' 16 images, the evaluation over 4 images; the semantic yaml's 2
# steps of SEMANTIC_POINTREND_CROPS crops and a batch forward of
# SEMANTIC_POINTREND_BATCH images at 1024x2048; PointSup's 3 and 2
# SimpleTrainer steps at 8 x 800x1344
POINTREND_TRAIN_ITERS, IMPLICIT_POINTREND_TRAIN_ITERS, SEMANTIC_POINTREND_ITERS = 3, 2, 2
POINTREND_TEST_IMAGES = 4
SEMANTIC_POINTREND_BATCH = 4
SEMANTIC_POINTREND_HW = (1024, 2048)  # the yaml's test size, Cityscapes' frames
SEMANTIC_POINTREND_CROPS = 2  # of the yaml's 32 a step
POINT_SUP_ITERS = {"point_sup": 3, "implicit_point_sup": 2}
POINT_SUP_POINTS = 5
POINTREND_NAMES = {"pointrend": "pointrend", "implicit_pointrend": "implicit_pointrend",
                   "semantic_pointrend": "semantic_pointrend", "point_sup": "point_sup",
                   "implicit_point_sup": "implicit_point_sup"}
POINTREND_KEYS = tuple(POINTREND_NAMES)
POINTREND_PER = {
    "pointrend": "box pool of one 16x800x1344 PointRend R50-FPN forward (the mask branch samples points)",
    "implicit_pointrend": "box pool of one 16x800x1344 Implicit PointRend R50-FPN forward",
    "pointrend_train": "box pool of the PointRend DefaultTrainer run's first 16-image batch",
    "implicit_pointrend_train": "box pool of the Implicit PointRend DefaultTrainer run's first 16-image batch",
    "point_sup_train": "box pool + 14x14 mask pool of PointSup's first 8x800x1344 SimpleTrainer step",
    "implicit_point_sup_train": "box pool of Implicit PointSup's first 8x800x1344 SimpleTrainer step",
}


def pointrend_cfg(name: str, opts=()):
    """``get_cfg()``, ``add_pointrend_config`` (and ``add_point_sup_config``
    for PointSup), then ``merge_from_file`` of the zoo yaml, as the JAX
    package builds these models; bf16, ``MODEL.WEIGHTS`` cleared (a
    download: seeded weights), SEED 0; then ``opts``."""
    from detectron2_tpu_torch.config import get_cfg
    from detectron2_tpu_torch.projects.point_rend import add_pointrend_config
    from detectron2_tpu_torch.projects.point_sup import add_point_sup_config

    cfg = get_cfg()
    add_pointrend_config(cfg)
    if name in ("point_sup", "implicit_point_sup"):
        add_point_sup_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", POINTREND_CONFIGS[name]))
    cfg.merge_from_list(["MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE", "bfloat16", "SEED", "0", *opts])
    return cfg


def seeded_predictor(device, cfg, calib_batch):
    """DefaultPredictor of ``cfg`` with seeded weights, FrozenBN calibrated on
    ``calib_batch`` (seeded weights with identity statistics blow a deep
    trunk's activations up), score threshold 0."""
    import torch

    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights

    predictor = DefaultPredictor(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(predictor.model, gen)
    calibrate_frozen_bn(predictor.model, calib_batch)
    if hasattr(predictor.model, "roi_heads"):
        score_threshold_zero(predictor.model)
    return predictor


def check_point_masks(model, batch, side: int, label: str) -> dict:
    """One more forward of ``batch``: the subdivision's ``side`` x ``side``
    mask probabilities in [0, 1], finite, on every detection slot; image 0's
    valid masks pasted into its frame on the card."""
    import torch

    from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image

    with torch.inference_mode():
        det = model(batch)
        masks = det["pred_masks"]
        check(masks.shape[2:] == (side, side) and torch.isfinite(masks).all(), f"{label}: masks {tuple(masks.shape)}")
        check(masks.min().item() >= 0 and masks.max().item() <= 1, f"{label}: mask probabilities outside [0, 1]")
        valid = det["valid"][0]
        h, w = batch["image"].shape[1:3]
        pasted = paste_masks_in_image(masks[0][valid].float(), det["pred_boxes"][0][valid], (h, w))
        check(pasted.device == masks.device and pasted.shape == (int(valid.sum()), h, w), tuple(pasted.shape))
    log(f"  {label}: masks {tuple(masks.shape)} in [{masks.min().item():.4f}, {masks.max().item():.4f}], "
        f"image 0's {int(valid.sum())} pasted on the card at {h}x{w}")
    return {"mask_side": side, "mask_min": masks.min().item(), "mask_max": masks.max().item()}


def pointrend_golden(device) -> dict:
    """``tests/goldens/e2e_pointrend_r18.npz`` on the card in float32: its
    d2 weights through the d2 loader (a .pkl written here), the detections
    and the top 10's 56x56 subdivision masks at its parity test's bounds."""
    import pickle

    import torch

    from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.testing import compare_with_pointrend_golden, golden_pointrend_config, golden_state_dict

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "e2e_pointrend_r18.npz"))
    cfg = golden_pointrend_config()
    cfg.MODEL.DEVICE = device.type
    model = build_model(cfg)
    with tempfile.NamedTemporaryFile(suffix=".pkl") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
        f.flush()
        report = load_d2_checkpoint(model, f.name)
    n = len(model.state_dict())
    check(report.splitlines() == [f"Loaded {n}/{n} tensors from the checkpoint."], report)
    zero_kernel_launches()
    with torch.inference_mode():
        out = model({"image": torch.from_numpy(golden["image"][None]).to(device),
                     "image_sizes": torch.tensor([[320, 320]], dtype=torch.int32, device=device)})
    errs = compare_with_pointrend_golden(out, golden)
    launches = kernel_counters()["B1"].launches
    check(launches == 1, f"PointRend golden: B1 launches {launches}")
    log(f"  PointRend R18 golden on the card, f32, d2 weights by name: max |err| {errs}; B1 launches {launches}")
    return errs


def pointrend_inference(device, name: str, label: str, requests: bool, side: int) -> dict:
    """The zoo yaml's predictor (seeded, calibrated on two noise images of
    the 16 x 800x1344 batch): with ``requests`` BACKBONE_REQUESTS through
    ``DefaultPredictor``, then one recorded and BACKBONE_FORWARDS timed batch
    forwards; B1 once a forward (the box pool), B2-B4 never; the masks."""
    cfg = pointrend_cfg(name)
    batch = noise_batch(device, B, H, W, 45)
    predictor = seeded_predictor(device, cfg, {k: v[:2] for k, v in batch.items()})
    model = predictor.model
    res = backbone_inference(model, label, batch, (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST), ("box",),
                             requests=requests)
    res.update(check_point_masks(model, batch, side, label))
    del predictor, model, batch
    free_card()
    return res


def pointrend_train(device, card: str, workdir: str, coco, name: str, label: str, iters: int, evaluate: bool) -> dict:
    """``tools/train_net.py``'s Trainer of the zoo yaml at its 16 images a
    step (640-800 / 1333, flips, ``MASK_FORMAT`` bitmask as the yaml has
    it) on the synthetic COCO for ``iters`` steps, seeded weights with
    FrozenBN calibrated on 4 train images, gradients clipped to a global
    norm of 1, warmup over 100; with ``evaluate`` COCOEvaluator over
    POINTREND_TEST_IMAGES images after training. B1/B2 once a step (the box
    pool), held on the first batch; finite losses (``loss_mask_point``, and
    ``loss_l2`` for the implicit heads); the mask heads moved."""
    import torch

    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.tools import train_net

    json_file, image_root = coco
    train_name, test_name = f"chip_smoke_{name}_train", f"chip_smoke_{name}_test"
    register_coco_instances(train_name, {}, json_file, image_root)
    register_coco_instances(test_name, {}, first_images(json_file, POINTREND_TEST_IMAGES,
                                                       os.path.join(workdir, f"{name}_test.json")), image_root)
    cfg = pointrend_cfg(name, ["SOLVER.MAX_ITER", str(iters), "SOLVER.WARMUP_ITERS", str(10 * TRAIN_STEPS),
                               "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0", "TEST.EVAL_PERIOD", "0",
                               "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "OUTPUT_DIR", os.path.join(workdir, name)])
    check((cfg.SOLVER.IMS_PER_BATCH, cfg.INPUT.MASK_FORMAT, cfg.MODEL.ROI_HEADS.NAME) == (
        16, "bitmask", "ImplicitPointRendROIHeads" if "implicit" in name else "PointRendROIHeads"),
        f"{POINTREND_CONFIGS[name]} as the zoo has it")
    cfg.DATASETS.TRAIN = (train_name,)
    cfg.DATASETS.TEST = (test_name,) if evaluate else ()
    trainer = rcnn_trainer(train_net, cfg, train_name)
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("roi_heads.mask_head.")}
    started, step_s, recorded, eval_s = [], [], [], []
    step_timer(trainer, started, step_s)
    result, steps, train_s, peak = train_counted(trainer, recorded, 1, COCOEvaluator if evaluate else None, eval_s)
    check(steps == [(1, 1)] * iters, f"{label}: per-step (B1, B2) launches {steps}")
    launches = (kernel_counters()["B1"].launches, kernel_counters()["B2"].launches)
    check(launches == (iters + (POINTREND_TEST_IMAGES if evaluate else 0), iters), f"{label}: launches {launches}")
    losses = ("loss_mask_point", "loss_l2") if "implicit" in name else ("loss_mask", "loss_mask_point")
    check_loss_values(trainer.storage, ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc") + losses, iters)
    moved(trainer.model, before)
    ap = {}
    if evaluate:
        ap = {t: result[t]["AP"] for t in ("bbox", "segm")}
        check(len(eval_s) == 1 and all(math.isfinite(v) and 0 <= v <= 100 for v in ap.values()), (ap, eval_s))
    log(f"  {label}: {iters} steps at {cfg.SOLVER.IMS_PER_BATCH} images in {train_s:.2f} s"
        + (f" with COCOEvaluator over {POINTREND_TEST_IMAGES} images ({eval_s[0]:.2f} s): bbox AP {ap['bbox']:.4f}, "
           f"segm AP {ap['segm']:.4f}" if evaluate else "")
        + f"; the {len(before)} mask head tensors moved; peak memory {peak:.2f} GiB; B1 {launches[0]}, B2 {launches[1]}")
    stats = step_summary(trainer.storage, step_s, cfg.SOLVER.IMS_PER_BATCH, card, label)
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-batch", keys=("box",))
    del trainer
    free_card()
    return {**stats, "peak_gib": peak, "train_s": train_s, "ap": ap, "launches": launches, "fwd": fwd, "bwd": bwd}


def semantic_pointrend(device, card: str, workdir: str) -> dict:
    """The semantic PointRend R101-FPN yaml on the synthetic Cityscapes (the
    builtin ``cityscapes_fine_sem_seg_*`` names): one 1024x2048 request,
    one plus BACKBONE_FORWARDS timed batch forwards of
    SEMANTIC_POINTREND_BATCH images at 1024x2048 (two subdivision steps of
    8192 points to the full resolution), then the Trainer at
    SEMANTIC_POINTREND_CROPS crops a step for SEMANTIC_POINTREND_ITERS steps (seeded weights;
    the yaml freezes nothing and keeps FrozenBN, calibrated on 4 train
    images) and CityscapesSemSegEvaluator over the val split. None of B1-B4
    launches."""
    import torch

    from detectron2_tpu_torch.data import DatasetCatalog
    from detectron2_tpu_torch.evaluation import CityscapesSemSegEvaluator
    from detectron2_tpu_torch.tools import train_net

    label = "semantic PointRend R101-FPN"
    if "cityscapes_fine_sem_seg_train" not in DatasetCatalog.list() or not os.path.exists(
            os.path.join(os.environ["DETECTRON2_DATASETS"], "cityscapes", "leftImg8bit")):
        data = cityscapes_data()
        log(f"  synthetic Cityscapes: {CITYSCAPES_TRAIN_IMAGES} train and {CITYSCAPES_VAL_IMAGES} val images, written in "
            f"{data['write_s']:.2f} s")
    cfg = pointrend_cfg("semantic_pointrend", ["SOLVER.MAX_ITER", str(SEMANTIC_POINTREND_ITERS), "SOLVER.WARMUP_ITERS",
                                               str(10 * TRAIN_STEPS), "TEST.EVAL_PERIOD", "0",
                                               "OUTPUT_DIR", os.path.join(workdir, "semantic_pointrend")])
    h = cfg.MODEL.POINT_HEAD
    check((cfg.MODEL.SEM_SEG_HEAD.NAME, h.NUM_CLASSES, h.TRAIN_NUM_POINTS, h.SUBDIVISION_STEPS, h.SUBDIVISION_NUM_POINTS,
           cfg.SOLVER.IMS_PER_BATCH, tuple(cfg.INPUT.CROP.SIZE), cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST,
           cfg.DATASETS.TRAIN, cfg.DATASETS.TEST)
          == ("PointRendSemSegHead", 19, 2048, 2, 8192, 32, (512, 1024), 1024, 2048, ("cityscapes_fine_sem_seg_train",),
              ("cityscapes_fine_sem_seg_val",)), f"{POINTREND_CONFIGS['semantic_pointrend']} as the zoo has it")
    zero_kernel_launches()
    sh, sw = SEMANTIC_POINTREND_HW
    batch = noise_batch(device, SEMANTIC_POINTREND_BATCH, sh, sw, 46)
    predictor = seeded_predictor(device, cfg, {k: v[:2] for k, v in batch.items()})
    img = np.random.RandomState(45).randint(0, 256, (sh, sw, 3)).astype(np.uint8)
    request_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = predictor(img)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(set(out) == {"sem_seg"} and out["sem_seg"].shape == (19, sh, sw) and torch.isfinite(out["sem_seg"]).all(),
              "semantic PointRend request")
    log(f"  {label} request {sh}x{sw}: first {request_ms[0]:.1f} ms, steady {request_ms[1]:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.inference_mode():
        for _ in range(1 + BACKBONE_FORWARDS):
            t0 = time.perf_counter()
            sem = predictor.model(batch)["sem_seg"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(sem.shape == (SEMANTIC_POINTREND_BATCH, sh, sw, 19) and torch.isfinite(sem).all(), tuple(sem.shape))
    batch_ms = float(np.median(times[1:]))
    log(f"  {label} batch forward {SEMANTIC_POINTREND_BATCH}x{sh}x{sw}: first {times[0]:.1f} ms, then median "
        f"{batch_ms:.1f} ms/batch ({SEMANTIC_POINTREND_BATCH / batch_ms * 1e3:.2f} img/s); peak memory {peak:.2f} GiB")
    del predictor, batch, sem
    free_card()

    # the cut (PERF.md section 4): the mapper crops before it resizes, as
    # the JAX package's does, so each 512x1024 crop grows to up to
    # 2048x4096 and SEMANTIC_POINTREND_CROPS images hold the pixels of the
    # yaml's 32 crops
    cfg.defrost()
    cfg.SOLVER.IMS_PER_BATCH = SEMANTIC_POINTREND_CROPS
    cfg.freeze()
    trainer = rcnn_trainer(train_net, cfg, "cityscapes_fine_sem_seg_train")
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k.startswith("sem_seg_head.")}
    started, step_s, eval_s = [], [], []
    step_timer(trainer, started, step_s)
    evaluate = CityscapesSemSegEvaluator.evaluate
    CityscapesSemSegEvaluator.evaluate = timing_evaluate(CityscapesSemSegEvaluator, eval_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = trainer.train()
    finally:
        CityscapesSemSegEvaluator.evaluate = evaluate
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    check_loss_values(trainer.storage, ("loss_sem_seg", "loss_sem_seg_point"), SEMANTIC_POINTREND_ITERS)
    moved(trainer.model, before)
    check(list(results) == ["sem_seg"] and len(eval_s) == 1, (list(results), eval_s))
    check(all(math.isfinite(v) for v in results["sem_seg"].values()), results["sem_seg"])
    keys = [k for k in ("IoU", "iIoU", "IoU_sup", "iIoU_sup") if k in results["sem_seg"]]
    check(keys, results["sem_seg"])
    log(f"  {label}: {SEMANTIC_POINTREND_ITERS} steps at {cfg.SOLVER.IMS_PER_BATCH} crops + CityscapesSemSegEvaluator over "
        f"{CITYSCAPES_VAL_IMAGES} images in {train_s:.2f} s (evaluate {eval_s[0]:.2f} s): "
        + ", ".join(f"{k} {results['sem_seg'][k]:.4f}" for k in keys) + f"; peak memory {train_peak:.2f} GiB")
    stats = step_summary(trainer.storage, step_s, cfg.SOLVER.IMS_PER_BATCH, card, label)
    del trainer
    free_card()
    counts = no_kernel_launches(label)
    return {"request_ms": request_ms, "batch_ms": batch_ms, "first_batch_ms": times[0],
            "img_s": SEMANTIC_POINTREND_BATCH / batch_ms * 1e3, "peak_gib": peak, "train": {**stats, "peak_gib": train_peak,
            "train_s": train_s}, "eval": {k: results["sem_seg"][k] for k in keys}, "launches": counts}


def point_sup_train(device, card: str, name: str, label: str, iters: int) -> dict:
    """The PointSup yaml's model (``add_point_sup_config``; d2's
    ``MaskRCNNConvUpsamplePointSupHead`` under ``StandardROIHeads`` is
    ``PointSupROIHeads``, ROADMAP C) through SimpleTrainer for ``iters``
    steps on phase 7's 8 x 800x1344 batch with POINT_SUP_POINTS points an
    instance inside its gt box (``testing.add_synthetic_points``; d2's
    point-annotation data is in neither package), seeded weights, FrozenBN
    calibrated on two of its images, the yaml's SGD with gradients clipped
    to a global norm of 1. B1/B2 once a pool a step (PointSup: box and 14x14
    mask pools; the implicit heads: the box pool), held on the first step;
    finite losses; the mask heads moved."""
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import SimpleTrainer, hooks
    from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.projects.point_sup import ImplicitPointRendPointSupROIHeads, PointSupROIHeads
    from detectron2_tpu_torch.solver import build_optimizer
    from detectron2_tpu_torch.testing import add_synthetic_points

    cfg = pointrend_cfg(name, ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0"])
    implicit = name == "implicit_point_sup"
    check((cfg.INPUT.POINT_SUP, cfg.INPUT.SAMPLE_POINTS, cfg.MODEL.ROI_MASK_HEAD.NAME) == (
        True, 5, "ImplicitPointRendPointSupHead" if implicit else "MaskRCNNConvUpsamplePointSupHead"),
        f"{POINTREND_CONFIGS[name]} as the zoo has it")
    model = build_model(cfg)
    check(type(model.roi_heads) is (ImplicitPointRendPointSupROIHeads if implicit else PointSupROIHeads),
          type(model.roi_heads).__name__)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    batch = synthetic_train_batch(device)
    host = add_synthetic_points({k: v.cpu().numpy() for k, v in batch.items() if k.startswith("gt_")},
                                POINT_SUP_POINTS, seed=45)
    batch.update(gt_point_coords=torch.from_numpy(host["gt_point_coords"]).to(device),
                 gt_point_labels=torch.from_numpy(host["gt_point_labels"]).to(device))
    del batch["gt_masks"]  # point supervision: no mask is read
    calibrate_frozen_bn(model, {k: batch[k][:2] for k in ("image", "image_sizes")})
    model.train()
    before = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith("roi_heads.mask_head.")}
    n_pools = 1 if implicit else 2
    sampling = torch.Generator(device=device)
    sampling.manual_seed(7)
    trainer = SimpleTrainer(model, [batch] * iters, build_optimizer(cfg, model), generator=sampling)
    fwd_k, bwd_k = kernel_counters()["B1"], kernel_counters()["B2"]
    per_step, step_s, started, recorded = [], [], [], []
    trainer.register_hooks([hooks.CallbackHook(
        before_step=lambda t: started.append(time.perf_counter()),
        after_step=lambda t: (torch.cuda.synchronize(), step_s.append(time.perf_counter() - started[-1]),
                              per_step.append((fwd_k.launches, bwd_k.launches))))])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with _Patched([(poolers, "roi_align_multilevel", lambda _: recording_pools(poolers, recorded, n_pools))]):
        trainer.train(0, iters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = step_launches(per_step)
    check(steps == [(n_pools, n_pools)] * iters, f"{label}: per-step (B1, B2) launches {steps}")
    launches = (fwd_k.launches, bwd_k.launches)
    losses = ("loss_mask_point", "loss_l2") if implicit else ("loss_mask",)
    check_loss_values(trainer.storage, ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc") + losses, iters)
    moved(model, before)
    step_ms = float(np.median(step_s[1:])) * 1e3
    log(f"  {label}: {iters} SimpleTrainer steps at {TRAIN_B}x{H}x{W}, {POINT_SUP_POINTS} points an instance; the "
        f"{len(before)} mask head tensors moved; median step {step_ms:.1f} ms (steps 2-{iters}) on {card}; peak memory "
        f"{peak:.2f} GiB; B1 {launches[0]}, B2 {launches[1]}")
    fwd, bwd = compare_recorded_pools(recorded, f"{label} first-step", keys=("box", "mask")[:n_pools])
    del trainer, model, batch
    free_card()
    return {"ms_per_step": step_ms, "peak_gib": peak, "launches": launches, "fwd": fwd, "bwd": bwd}


def phase_pointrend(device, card: str, workdir: str, coco):
    """PointRend and PointSup at full width (bf16, seeded weights, the zoo
    yamls as they are; the cuts in PERF.md section 4): (a) the golden in
    float32; PointRend R50-FPN 3x's 2 requests, 16 x 800x1344 batch forward
    (28x28 masks, pasted on the card), POINTREND_TRAIN_ITERS DefaultTrainer
    steps and COCOEvaluator; (b) Implicit PointRend's batch forward (224x224
    masks) and IMPLICIT_POINTREND_TRAIN_ITERS steps; (c) semantic PointRend
    R101-FPN on Cityscapes; (d) PointSup and Implicit PointSup SimpleTrainer
    steps with annotated points. B1 once a forward and B2 once a step on
    the PointRend paths, twice each on PointSup's, held to their plain
    versions on the recorded pools; 0 on the semantic path; B3/B4 0."""
    t_phase = time.perf_counter()
    res = {"pointrend_golden_max_abs_err": pointrend_golden(device)}
    pools, train_fwd, train_bwd, b1, b2 = {}, {}, {}, 0, 0
    inference = {
        "pointrend": pointrend_inference(device, "pointrend", "PointRend R50-FPN", True, 28),
        "implicit_pointrend": pointrend_inference(device, "implicit_pointrend", "Implicit PointRend R50-FPN", False, 224),
    }
    for name, r in inference.items():
        pools[name] = (r["pools"], POINTREND_PER[name])
        b1 += r["launches"]
        res.update(backbone_result(name, r))
        res[f"{name}_mask_side"] = r["mask_side"]
    for name, label, iters, evaluate in (("pointrend", "PointRend R50-FPN", POINTREND_TRAIN_ITERS, True),
                                         ("implicit_pointrend", "Implicit PointRend R50-FPN", IMPLICIT_POINTREND_TRAIN_ITERS,
                                          False)):
        t = pointrend_train(device, card, workdir, coco, name, label, iters, evaluate)
        res.update(backbone_result(name, train=t))
        res[f"{name}_train_launches"] = t["launches"]
        train_fwd[name] = (t["fwd"], POINTREND_PER[f"{name}_train"])
        train_bwd[name] = (t["bwd"], POINTREND_PER[f"{name}_train"])
        b1, b2 = b1 + t["launches"][0], b2 + t["launches"][1]
    sem = semantic_pointrend(device, card, workdir)
    res.update({f"semantic_pointrend_{k}": v for k, v in sem.items() if k != "train"})
    res.update({f"semantic_pointrend_train_{k}": v for k, v in sem["train"].items()})
    for name, label in (("point_sup", "PointSup R50-FPN"), ("implicit_point_sup", "Implicit PointSup R50-FPN")):
        t = point_sup_train(device, card, name, label, POINT_SUP_ITERS[name])
        res.update({f"{name}_train_{k}": t[k] for k in ("ms_per_step", "peak_gib", "launches")})
        train_fwd[name] = (t["fwd"], POINTREND_PER[f"{name}_train"])
        train_bwd[name] = (t["bwd"], POINTREND_PER[f"{name}_train"])
        b1, b2 = b1 + t["launches"][0], b2 + t["launches"][1]
    res.update(pointrend_phase_s=time.perf_counter() - t_phase, b1_launches=b1, b2_launches=b2, pools=pools,
               train_fwd=train_fwd, train_bwd=train_bwd)
    return res


def pointrend_kernels_line(res: dict) -> dict:
    """``--pointrend-only``'s kernels line: B1/B2 with phase 45's launches,
    errors and pools (the box pool of one PointRend forward as the
    headline), B3/B4 at their 0 launches; what this mode does not run is
    null."""
    r = res[45]
    b1_pools = dconv_densepose_pools(res, "fwd")
    b2_pools = dconv_densepose_pools(res, "bwd")
    head = pools_entry(r["pools"]["pointrend"][0], POINTREND_PER["pointrend"])
    head_bwd = pools_entry(r["train_bwd"]["pointrend"][0], "backward of " + POINTREND_PER["pointrend_train"])
    entry = lambda name, replaces: {"name": name, "route": "cuda", "source": "detectron2_tpu_torch/csrc/roi_align.cu",  # noqa: E731
                                    "replaces": replaces, "library_ms": None}
    b1 = {**entry("roi_align_multilevel_fwd", "detectron2_tpu/ops/pallas/roi_align_pallas.py:226"),
          "launches": r["b1_launches"], **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "per_forward")},
          "max_abs_err": max(p["max_abs_err"] for pools in b1_pools for p in pools.values()),
          **dconv_densepose_entries(res, "fwd")}
    b2 = {**entry("roi_align_multilevel_bwd", "detectron2_tpu/ops/pallas/roi_align_pallas.py:521"),
          "launches": r["b2_launches"], **{k: head_bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "per_forward")},
          "max_abs_err": max(p["max_abs_err"] for pools in b2_pools for p in pools.values()),
          **dconv_densepose_entries(res, "bwd")}
    attn = [{"name": name, "route": "cuda", "source": "detectron2_tpu_torch/csrc/flash_attention.cu", "replaces": replaces,
             "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
             "library_ms": None, "note": "0 launches on phase 45's paths (checked); timed in the full run"}
            for name, replaces in (("flash_attention_fwd", "detectron2_tpu/ops/pallas/flash_attention.py:296"),
                                   ("flash_attention_fwd_t", "detectron2_tpu/ops/pallas/flash_attention.py:189"))]
    return {"kernels": [b1, b2] + attn}


def run_pointrend_phases(timed, device, card: str, workdir: str, coco) -> dict:
    with attention_free("phase 45"):
        return {45: timed(45, "PointRend (standard, implicit, semantic) and PointSup: the golden, requests, batch forwards, "
                              "training, evaluation", phase_pointrend, device, card, workdir, coco)}


def timed_alone(n, title, fn, *args):
    """Phase ``n`` of a ``--*-only`` mode, logged with its seconds."""
    log(f"== phase {n}: {title}")
    t0 = time.perf_counter()
    res = fn(*args)
    log(f"  phase {n} took {time.perf_counter() - t0:.1f} s")
    free_card()
    return res


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    # the port registers the builtin dataset names under $DETECTRON2_DATASETS
    # at import: phases 32-33, 35 and 40 write their synthetic trees into the run's own
    datasets_root = tempfile.mkdtemp(prefix="chip_smoke_datasets_")
    atexit.register(shutil.rmtree, datasets_root, True)
    os.environ["DETECTRON2_DATASETS"] = datasets_root
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import detectron2_tpu_torch
        from detectron2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 3
    if os.path.dirname(os.path.dirname(os.path.abspath(detectron2_tpu_torch.__file__))) != here:
        print("chip_smoke: detectron2_tpu_torch must come from this checkout", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    t_run = time.perf_counter()
    log("== phase 1: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for convolutions and matmuls (comparison phases run in full float32)")

    log("== phase 2: build")
    if "--ptxas" in sys.argv[1:]:
        log(_build.ptxas_report())
    t0 = time.perf_counter()
    _build.build_kernels()
    log(f"built {list(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.2f} s")

    if "--gate-determinism" in sys.argv[1:]:
        log("== the gate's reproducibility (no main path is driven, so no result line)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            print(json.dumps({"gate_determinism": gate_determinism(device, workdir)}), flush=True)
        return 0

    if "--vitdet-train-only" in sys.argv[1:]:
        log("== phase 23 alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            res = phase_vitdet_train(device, smi, workdir, coco)
        print(json.dumps({k: v for k, v in res.items() if k.startswith("vitdet_train_")}), flush=True)
        return 0

    if "--bn-only" in sys.argv[1:]:
        log("== phases 24 and 25 alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            out = {}
            for n, title, fn in ((24, "new_baselines R50-FPN LSJ training (lazyconfig_train_net)", phase_lsj_train),
                                 (25, "DefaultTrainer with PreciseBN (Misc syncbn yaml)", phase_precise_bn)):
                log(f"== phase {n}: {title}")
                t0 = time.perf_counter()
                res = fn(device, smi, workdir, coco)
                log(f"  phase {n} took {time.perf_counter() - t0:.1f} s")
                out.update({k: v for k, v in res.items() if k.startswith(("lsj_train_", "precise_bn_"))})
                torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        return 0

    if "--dense-only" in sys.argv[1:]:
        log("== phases 26-28 alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            out = {}
            for n, title, fn in DENSE_PHASES:
                log(f"== phase {n}: {title}")
                t0 = time.perf_counter()
                out.update(fn(device, smi, workdir, coco))
                log(f"  phase {n} took {time.perf_counter() - t0:.1f} s")
                torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
        return 0

    if "--lvis-voc-only" in sys.argv[1:]:
        log("== phases 29-31 alone (no other path is driven, so no result line)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = run_lvis_voc_phases(timed_alone, device, smi, workdir)
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(("lvis_", "voc_"))}), flush=True)
        return 0

    if "--seg-only" in sys.argv[1:]:
        log("== phases 32-33 alone (no other path is driven, so no result line)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = run_seg_phases(timed_alone, device, smi, workdir)
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(("seg_", "panoptic_", "semantic_"))}),
              flush=True)
        return 0

    if "--rcnn-options-only" in sys.argv[1:]:
        log("== phases 34-35 alone (no other path is driven, so no result line)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = run_rcnn_options_phases(timed_alone, device, smi, workdir)
        print(json.dumps({k: v for r in res.values() for k, v in r.items()
                          if k.startswith(("rcnn_", "fast_rcnn_", "giou_", "pred_boxes_", "cityscapes_"))}), flush=True)
        return 0

    if "--backbones-only" in sys.argv[1:]:
        log("== phases 36-38 alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            res = run_backbone_phases(timed_alone, device, smi, workdir, coco)
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(BACKBONE_KEYS)}), flush=True)
        return 0

    if "--dconv-densepose-only" in sys.argv[1:] or "--cse-only" in sys.argv[1:]:
        cse_only = "--cse-only" in sys.argv[1:]
        log(f"== phases {'40-42' if cse_only else '39-40'} alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = None if cse_only else write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            res = run_dconv_densepose_phases(timed_alone, device, smi, workdir, coco, (40, 41, 42) if cse_only else (39, 40))
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(DCONV_DENSEPOSE_KEYS)}), flush=True)
        return 0

    if "--hrfpn-bootstrap-only" in sys.argv[1:]:
        log("== phases 43-44 alone (no other path is driven, so no result line)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            res = run_hrfpn_bootstrap_phases(timed_alone, device, smi, workdir)
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(HRFPN_BOOTSTRAP_KEYS)}),
              flush=True)
        return 0

    if "--pointrend-only" in sys.argv[1:]:
        log("== phase 45 alone (no other path is driven, so no result line)")
        from detectron2_tpu_torch.testing import write_synthetic_coco

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            coco = write_synthetic_coco(os.path.join(workdir, "coco"), EVAL_IMAGES, seed=0)
            res = run_pointrend_phases(timed_alone, device, smi, workdir, coco)
        print(json.dumps(pointrend_kernels_line(res)), flush=True)
        print(json.dumps({k: v for r in res.values() for k, v in r.items() if k.startswith(POINTREND_KEYS)}), flush=True)
        return 0

    if "--kernels-only" in sys.argv[1:]:
        with torch.inference_mode():
            log("== phase 3: RoIAlign kernel vs plain at the main-path shapes")
            phase_kernel_vs_plain(device)
            log("== phase 8: attention kernels vs plain at the ViTDet-B shapes")
            phase_attention_vs_plain(device)
        log("== phase 6: RoIAlign backward kernel vs plain at the train shapes")
        phase_backward_vs_plain(device)
        log("== phase 18: RoIAlign kernels vs plain at the heads' train shapes")
        phase_train_shapes(device)
        log("kernels only: ok (no main path was driven, so no result line)")
        return 0

    seconds = {}

    def timed(n, title, fn, *args):
        log(f"== phase {n}: {title}")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = time.perf_counter() - t0
        log(f"  phase {n} took {seconds[n]:.1f} s")
        free_card()
        return out

    with torch.inference_mode():
        synthetic = timed(3, "RoIAlign kernel vs plain at the main-path shapes", phase_kernel_vs_plain, device)
        timed(4, "golden fixture on the card", phase_golden, device)
        main_path = timed(5, "main path, full width", phase_main_path, device)

    synthetic_bwd = timed(6, "RoIAlign backward kernel vs plain at the train shapes", phase_backward_vs_plain, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        train = timed(7, "training, full width", phase_train, device, workdir)
        torch.cuda.empty_cache()

        with torch.inference_mode():
            synthetic_attn = timed(8, "attention kernels vs plain at the ViTDet-B shapes", phase_attention_vs_plain, device)
            vitdet = timed(9, "ViTDet main path, full width", phase_vitdet, device)
            evaluation = timed(10, "COCO evaluation, full width", phase_eval, device, main_path["state_dict"], smi, workdir)
        torch.cuda.empty_cache()

        trainer = timed(11, "DefaultTrainer, full width", phase_default_trainer, device, smi, workdir, train["weights"],
                        evaluation["coco"])
        torch.cuda.empty_cache()

        gate = timed(12, "the train->AP gate", phase_train_to_ap, device, smi, workdir)
        torch.cuda.empty_cache()

        with torch.inference_mode():
            new_shapes = timed(13, "RoIAlign kernel vs plain at the shapes of the other R-CNN heads", phase_new_shapes, device)
            torch.cuda.empty_cache()
            heads = {}
            heads["keypoint"] = timed(14, "Keypoint R-CNN R50-FPN 3x, full width", phase_heads, device, "keypoint", KPT_CONFIG)
            log("== phase 14: keypoint --eval-only (DefaultTrainer.test)")
            t0 = time.perf_counter()
            kpt_eval = phase_keypoint_eval(device, heads["keypoint"].pop("model"), heads["keypoint"]["cfg"], workdir, smi)
            seconds["14 eval"] = time.perf_counter() - t0
            log(f"  phase 14's evaluation took {seconds['14 eval']:.1f} s")
            torch.cuda.empty_cache()
            heads["c4"] = timed(15, "Mask R-CNN R50-C4 3x, full width", phase_heads, device, "c4", C4_CONFIG)
            del heads["c4"]["model"]
            torch.cuda.empty_cache()
            heads["cascade"] = timed(16, "Cascade Mask R-CNN R50-FPN 3x, full width", phase_heads, device, "cascade", CASCADE_CONFIG)
            del heads["cascade"]["model"]
            torch.cuda.empty_cache()
            tta = timed(17, "test-time augmentation, R50-FPN 3x", phase_tta, device, main_path.pop("state_dict"),
                        evaluation["coco"], smi)
        torch.cuda.empty_cache()

        train_shapes = timed(18, "RoIAlign kernels vs plain at the heads' train shapes", phase_train_shapes, device)
        torch.cuda.empty_cache()
        heads_train = {}
        for n, name, title in ((19, "keypoint", "Keypoint R-CNN"), (20, "c4", "Mask R-CNN R50-C4"),
                               (21, "cascade", "Cascade Mask R-CNN")):
            heads_train[name] = timed(n, f"{title} 3x training, full width (DefaultTrainer)", phase_heads_train, device,
                                      smi, workdir, name, evaluation["coco"])
            torch.cuda.empty_cache()
        kpt_gate = timed(22, "the keypoint train->AP gate", phase_train_to_ap, device, smi, workdir, True)
        torch.cuda.empty_cache()
        vitdet_train = timed(23, "ViTDet-B training from the LazyConfig (lazyconfig_train_net)", phase_vitdet_train, device,
                             smi, workdir, evaluation["coco"])
        torch.cuda.empty_cache()
        lsj_train = timed(24, "new_baselines R50-FPN LSJ training from scratch (lazyconfig_train_net)", phase_lsj_train,
                          device, smi, workdir, evaluation["coco"])
        precise_bn = timed(25, "DefaultTrainer with PreciseBN (Misc syncbn yaml)", phase_precise_bn, device, smi, workdir,
                           evaluation["coco"])
        torch.cuda.empty_cache()
        dense = {}
        for n, title, fn in DENSE_PHASES:
            dense.update(timed(n, title, fn, device, smi, workdir, evaluation["coco"]))
            torch.cuda.empty_cache()
        lvis_voc = run_lvis_voc_phases(timed, device, smi, workdir)
        seg = run_seg_phases(timed, device, smi, workdir)
        rcnn_options = run_rcnn_options_phases(timed, device, smi, workdir)
        backbones = run_backbone_phases(timed, device, smi, workdir, evaluation["coco"])
        dconv_densepose = run_dconv_densepose_phases(timed, device, smi, workdir, evaluation["coco"])
        hrfpn_bootstrap = run_hrfpn_bootstrap_phases(timed, device, smi, workdir)
        pointrend = run_pointrend_phases(timed, device, smi, workdir, evaluation["coco"])
    lvis, lvis_vitdet, voc = lvis_voc[29], lvis_voc[30], lvis_voc[31]
    panoptic = seg[32]
    options, cityscapes = rcnn_options[34], rcnn_options[35]
    total_s = time.perf_counter() - t_run
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}" for k, v in seconds.items()) + f"; run total {total_s:.1f} s")

    pools = ((BOX_RES, "box pool"), (MASK_RES, "mask pool"))

    def per_pool(results, synthetic_results=None):
        """One entry per pool, with the synthetic-roi times where given."""
        out = []
        for res, name in pools:
            entry = {"pool": name, "res": results[res].get("res", res)}
            entry.update({k: results[res][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "max_abs_err_f32", "path",
            ) if k in results[res]})
            if synthetic_results:
                entry.update(synthetic_ms=synthetic_results[res]["ms"], synthetic_plain_ms=synthetic_results[res]["plain_ms"])
            out.append(entry)
        return out

    def summed(results):
        """Both pools together: times add; the bound of the summed work."""
        b_ms, b_by = bound(sum(results[r]["bytes"] for r, _ in pools), sum(results[r]["flops"] for r, _ in pools))
        return {
            "max_abs_err": max(results[r]["max_abs_err"] for r, _ in pools),
            "ms": sum(results[r]["ms"] for r, _ in pools),
            "plain_ms": sum(results[r]["plain_ms"] for r, _ in pools),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }

    def attention_kernel(name, replaces, transposed, launches, paths, train=None):
        """One forward's 12 launches (4 global + 8 windowed) on the main
        path's inputs; per shape also the synthetic-input times; with
        ``train``, phase 23's launches and its recorded train blocks."""
        main, synth = vitdet["attn"][transposed], synthetic_attn[transposed]
        per_forward = lambda key: sum(ATTN_PER_FORWARD[n] * main[n][key] for n in ATTN_SHAPES)  # noqa: E731
        b_ms, b_by = bound(
            sum(ATTN_PER_FORWARD[n] * main[n]["bytes"] for n in ATTN_SHAPES),
            sum(ATTN_PER_FORWARD[n] * main[n]["flops"] for n in ATTN_SHAPES), H100_BF16_FLOPS,
        )
        shape_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_bias_ms", "max_abs_err")
        entry = {
            "name": name,
            "route": "cuda",
            "source": "detectron2_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": launches,
            "paths": paths,
            "max_abs_err": max(main[n]["max_abs_err"] for n in ATTN_SHAPES),
            "ms": per_forward("ms"),
            "plain_ms": per_forward("plain_ms"),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": per_forward("library_ms"),
            "library_bias_ms": per_forward("library_bias_ms"),
            "bound_peak": "989 TFLOP/s dense bf16 tensor cores, 3.35 TB/s",
            "per_forward": "4 global + 8 windowed launches of one 8x1024x1024 ViTDet-B forward, bf16",
            "head_dim_80": [
                {
                    "shape": n, "qkv": list(ATTN_D80_SHAPES[n][:3]), "dtype": "bfloat16", "bias": True,
                    **{k: synthetic_attn["d80"][transposed][n][k] for k in shape_keys + ("path",)},
                }
                for n in ATTN_D80_SHAPES
            ],
            "shapes": [
                {
                    "shape": n, "qkv": list(ATTN_SHAPES[n][:3]), "launches_per_forward": ATTN_PER_FORWARD[n],
                    "path": main[n]["path"],
                    **{k: main[n][k] for k in shape_keys},
                    **{f"synthetic_{k}": synth[n][k] for k in (
                        "ms", "no_bias_ms", "folded_bias_ms", "plain_ms", "library_ms", "library_bias_ms",
                    ) if k in synth[n]},
                }
                for n in ATTN_SHAPES
            ],
        }
        if train is not None:
            entry["launches"] += train["attn_launches"]
            entry["vitdet_train_launches"] = train["attn_launches"]
            entry["vitdet_train_paths"] = train["attn_paths"]
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [train["attn"][n]["max_abs_err"] for n in ATTN_SHAPES])
            entry["vitdet_train"] = {
                "per_step": "4 global + 8 windowed launches of one 8x1024x1024 ViTDet-B train step, bf16, recorded inputs",
                "shapes": [{"shape": n, **{k: train["attn"][n][k] for k in shape_keys + ("path", "grad_max_abs_err")}}
                           for n in ATTN_SHAPES],
            }
        return entry

    def with_lvis_vitdet(entry, res):
        """B3's entry with phase 30's launches (training, evaluation and the
        cascade forward) and its recorded train blocks."""
        shape_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "path", "grad_max_abs_err")
        entry["launches"] += res["b3_launches"]
        entry["lvis_vitdet_launches"] = res["b3_launches"]
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [res["attn"][n]["max_abs_err"] for n in ATTN_SHAPES])
        entry["lvis_vitdet_train"] = {
            "per_step": "4 global + 8 windowed launches of one 8x1024x1024 ViTDet-B LVIS train step, bf16, recorded inputs",
            "shapes": [{"shape": n, **{k: res["attn"][n][k] for k in shape_keys}} for n in ATTN_SHAPES],
        }
        return entry

    kernels = {
        "kernels": [
            {
                "name": "roi_align_multilevel_fwd",
                "route": "cuda",
                "source": "detectron2_tpu_torch/csrc/roi_align.cu",
                "replaces": "detectron2_tpu/ops/pallas/roi_align_pallas.py:226",
                "launches": main_path["launches"] + train["fwd_launches"] + vitdet["roi_launches"] + evaluation["roi_launches"]
                + trainer["fwd_launches"] + gate["fwd_launches"] + sum(h["launches"] for h in heads.values())
                + kpt_eval["kpt_eval_launches"] + tta["launches"]
                + sum(h["fwd_launches"] for h in heads_train.values()) + kpt_gate["fwd_launches"]
                + vitdet_train["fwd_launches"] + lsj_train["fwd_launches"] + precise_bn["fwd_launches"]
                + sum(r["b1_launches"] for r in lvis_voc.values()) + panoptic["b1_launches"]
                + sum(r["b1_launches"] for r in rcnn_options.values()) + sum(r["b1_launches"] for r in backbones.values())
                + sum(r["b1_launches"] for r in dconv_densepose.values())
                + sum(r["b1_launches"] for r in hrfpn_bootstrap.values()) + pointrend[45]["b1_launches"],
                "inference_launches": main_path["launches"],
                "train_launches": train["fwd_launches"],
                "vitdet_launches": vitdet["roi_launches"],
                "eval_launches": evaluation["roi_launches"],
                "default_trainer_launches": trainer["fwd_launches"],
                "gate_launches": gate["fwd_launches"],
                "keypoint_launches": heads["keypoint"]["launches"] + kpt_eval["kpt_eval_launches"],
                "c4_launches": heads["c4"]["launches"],
                "cascade_launches": heads["cascade"]["launches"],
                "tta_launches": tta["launches"],
                **{f"{name}_train_launches": h["fwd_launches"] for name, h in heads_train.items()},
                "keypoint_gate_launches": kpt_gate["fwd_launches"],
                "vitdet_train_launches": vitdet_train["fwd_launches"],
                "lsj_train_launches": lsj_train["fwd_launches"],
                "precise_bn_launches": precise_bn["fwd_launches"],
                "lvis_launches": lvis["b1_launches"],
                "lvis_vitdet_launches": lvis_vitdet["b1_launches"],
                "voc_launches": voc["b1_launches"],
                "panoptic_launches": panoptic["b1_launches"],
                "semantic_launches": seg[33]["semantic_kernel_launches"]["B1"],
                **{f"{path}_launches": n[0] for path, n in options["launches"].items()},
                "cityscapes_launches": cityscapes["b1_launches"],
                **{f"{name}_launches": backbones[n]["b1_launches"] for n, name in BACKBONE_NAMES.items()},
                **{f"{name}_launches": dconv_densepose[n]["b1_launches"] for n, name in DCONV_DENSEPOSE_NAMES.items()},
                **{f"{name}_launches": hrfpn_bootstrap[n]["b1_launches"] for n, name in HRFPN_BOOTSTRAP_NAMES.items()},
                "pointrend_launches": pointrend[45]["b1_launches"],
                "semantic_pointrend_launches": pointrend[45]["semantic_pointrend_launches"]["B1"],
                "paths": {"inference, train, vitdet": "vector (checked per pool)", "eval": evaluation["roi_paths"],
                          "default_trainer, gate, keypoint, c4, cascade, *_train, keypoint_gate, vitdet_train, lsj_train":
                          "vector (checked per launch)",
                          "train_shapes": "vector (checked per case)",
                          "tta": "vector (checked per pool)"},
                **summed(main_path["shapes"]),
                "max_abs_err": max([summed(r)["max_abs_err"] for r in (
                    main_path["shapes"], train["fwd"], vitdet["pools"], evaluation["pools"], trainer["fwd"], gate["fwd"],
                )] + [r["max_abs_err"] for r in new_shapes.values()]
                    + [p["max_abs_err"] for h in list(heads.values()) + [tta] for p in h["pools"].values()]
                    + [r["fwd"]["max_abs_err"] for r in train_shapes.values()]
                    + [p["max_abs_err"] for h in list(heads_train.values()) + [kpt_gate, vitdet_train, lsj_train, precise_bn]
                       for p in h["fwd"].values()]
                    + [p["max_abs_err"] for pools in (lvis["pools"], lvis["fwd"], lvis_vitdet["fwd"], lvis_vitdet["cascade_pools"],
                                                      voc["fwd"], voc["c4_pools"], panoptic["pools"], panoptic["fwd"],
                                                      panoptic["lazy_pools"], options["pools"], options["fwd"],
                                                      options["giou_fwd"], cityscapes["fwd"]) for p in pools.values()]
                    + [p["max_abs_err"] for pools in backbone_pools(backbones, "fwd") for p in pools.values()]
                    + [p["max_abs_err"] for pools in dconv_densepose_pools(dconv_densepose, "fwd") for p in pools.values()]
                    + [p["max_abs_err"] for pools in dconv_densepose_pools(hrfpn_bootstrap, "fwd") for p in pools.values()]
                    + [p["max_abs_err"] for pools in dconv_densepose_pools(pointrend, "fwd") for p in pools.values()]),
                "library_ms": None,
                "per_forward": "box pool + mask pool of one 16x800x1344 forward",
                "shapes": per_pool(main_path["shapes"], synthetic),
                "train": {**summed(train["fwd"]), "per_step": "box pool + mask pool of one 8x800x1344 train step",
                          "shapes": per_pool(train["fwd"])},
                "vitdet": {**summed(vitdet["pools"]), "per_forward": "box pool + mask pool of one 8x1024x1024 ViTDet-B forward",
                           "shapes": per_pool(vitdet["pools"])},
                "eval": {**summed(evaluation["pools"]), "per_batch": "box pool + mask pool of the eval loader's first 1-image batch",
                         "shapes": per_pool(evaluation["pools"])},
                "default_trainer": {**summed(trainer["fwd"]),
                                    "per_step": "box pool + mask pool of DefaultTrainer's first 16-image batch",
                                    "shapes": per_pool(trainer["fwd"])},
                "gate": {**summed(gate["fwd"]), "per_step": "box pool + mask pool of the gate's first 8x64x64 float32 batch",
                         "shapes": per_pool(gate["fwd"])},
                "new_shapes": {name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "path")}
                               for name, r in new_shapes.items()},
                "keypoint": pools_entry(heads["keypoint"]["pools"], "box pool + keypoint pool of one 16x800x1344 forward"),
                "c4": pools_entry(heads["c4"]["pools"], "box pool + mask pool (res4, 1024 channels) of one 16x800x1344 forward"),
                "cascade": pools_entry(heads["cascade"]["pools"], "3 stage box pools + mask pool of one 16x800x1344 forward"),
                "tta": pools_entry(tta["pools"], "box pool + mask pool of the first augmented copy (shortest edge 400)"),
                "train_shapes": {name: {"res": r["res"], **{k: r["fwd"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "path")}} for name, r in train_shapes.items()},
                **{f"{name}_train": pools_entry(h["fwd"], HEAD_TRAIN_PER_STEP[name]) for name, h in heads_train.items()},
                "keypoint_gate": pools_entry(kpt_gate["fwd"], "box pool + keypoint pool of the keypoint gate's first 8x64x64 float32 batch"),
                "vitdet_train": pools_entry(vitdet_train["fwd"], "box pool + mask pool of the ViTDet-B train run's first 8x1024x1024 LSJ batch"),
                "lsj_train": pools_entry(lsj_train["fwd"], f"box pool + mask pool of the R50-FPN LSJ run's first {LSJ_TRAIN_BATCH}x1024x1024 batch"),
                "precise_bn": pools_entry(precise_bn["fwd"], "box pool + mask pool of the syncbn yaml run's first 16-image batch"),
                "lvis": pools_entry(lvis["pools"], "box pool + mask pool of one 16x800x1344 LVIS R50-FPN forward (1203 classes)"),
                "lvis_train": pools_entry(lvis["fwd"], "box pool + mask pool of the LVIS DefaultTrainer run's first 16-image batch"),
                "lvis_vitdet_train": pools_entry(lvis_vitdet["fwd"], "box pool + mask pool of the ViTDet-B LVIS run's first 8x1024x1024 batch"),
                "lvis_cascade": pools_entry(lvis_vitdet["cascade_pools"], "3 stage box pools + mask pool of one 8x1024x1024 cascade ViTDet-B LVIS forward"),
                "voc_train": pools_entry(voc["fwd"], "box pool of the VOC R50-FPN run's first 16-image batch"),
                "voc_c4": pools_entry(voc["c4_pools"], "res4 pool (1024 channels) of one 16x800x1344 VOC R50-C4 forward"),
                "panoptic": pools_entry(panoptic["pools"], "box pool + mask pool of one 16x800x1344 PanopticFPN forward"),
                "panoptic_train": pools_entry(panoptic["fwd"], "box pool + mask pool of the PanopticFPN DefaultTrainer run's first 16-image batch"),
                "panoptic_lazy": pools_entry(panoptic["lazy_pools"], "14x14 box pool (get_cfg()'s) + mask pool of the lazy PanopticFPN's first eval image"),
                "fast_rcnn": pools_entry(options["pools"], "box pool of one 16x800x1344 Fast R-CNN forward, 1000 precomputed proposals an image"),
                "fast_rcnn_train": pools_entry(options["fwd"], "box pool of the Fast R-CNN DefaultTrainer run's first 16-image batch"),
                "giou_train": pools_entry(options["giou_fwd"], "box pool + mask pool of the GIoU yaml run's first 16-image batch"),
                "cityscapes_train": pools_entry(cityscapes["fwd"], "box pool + mask pool of the Cityscapes run's first 8-image batch, up to 1024x2048"),
                **backbone_entries(backbones, "fwd"),
                **dconv_densepose_entries(dconv_densepose, "fwd"),
                **dconv_densepose_entries(hrfpn_bootstrap, "fwd"),
                **dconv_densepose_entries(pointrend, "fwd"),
            },
            {
                "name": "roi_align_multilevel_bwd",
                "route": "cuda",
                "source": "detectron2_tpu_torch/csrc/roi_align.cu",
                "replaces": "detectron2_tpu/ops/pallas/roi_align_pallas.py:521",
                "launches": train["bwd_launches"] + trainer["bwd_launches"] + gate["bwd_launches"]
                + sum(h["bwd_launches"] for h in heads_train.values()) + kpt_gate["bwd_launches"]
                + vitdet_train["bwd_launches"] + lsj_train["bwd_launches"] + precise_bn["bwd_launches"]
                + sum(r["b2_launches"] for r in lvis_voc.values()) + panoptic["b2_launches"]
                + sum(r["b2_launches"] for r in rcnn_options.values()) + sum(r["b2_launches"] for r in backbones.values())
                + sum(r["b2_launches"] for r in dconv_densepose.values())
                + sum(r["b2_launches"] for r in hrfpn_bootstrap.values()) + pointrend[45]["b2_launches"],
                "train_launches": train["bwd_launches"],
                "default_trainer_launches": trainer["bwd_launches"],
                "gate_launches": gate["bwd_launches"],
                **{f"{name}_train_launches": h["bwd_launches"] for name, h in heads_train.items()},
                "keypoint_gate_launches": kpt_gate["bwd_launches"],
                "vitdet_train_launches": vitdet_train["bwd_launches"],
                "lsj_train_launches": lsj_train["bwd_launches"],
                "precise_bn_launches": precise_bn["bwd_launches"],
                "lvis_launches": lvis["b2_launches"],
                "lvis_vitdet_launches": lvis_vitdet["b2_launches"],
                "voc_launches": voc["b2_launches"],
                "panoptic_launches": panoptic["b2_launches"],
                "semantic_launches": seg[33]["semantic_kernel_launches"]["B2"],
                **{f"{path}_launches": n[1] for path, n in options["launches"].items()},
                "cityscapes_launches": cityscapes["b2_launches"],
                **{f"{name}_launches": backbones[n]["b2_launches"] for n, name in BACKBONE_NAMES.items()},
                **{f"{name}_launches": dconv_densepose[n]["b2_launches"] for n, name in DCONV_DENSEPOSE_NAMES.items()},
                **{f"{name}_launches": hrfpn_bootstrap[n]["b2_launches"] for n, name in HRFPN_BOOTSTRAP_NAMES.items()},
                "pointrend_launches": pointrend[45]["b2_launches"],
                "semantic_pointrend_launches": pointrend[45]["semantic_pointrend_launches"]["B2"],
                "path": train["bwd"][BOX_RES]["path"],
                **summed(train["bwd"]),
                "max_abs_err": max([summed(r)["max_abs_err"] for r in (train["bwd"], trainer["bwd"], gate["bwd"])]
                                   + [r["bwd"]["max_abs_err"] for r in train_shapes.values()]
                                   + [p["max_abs_err"] for h in list(heads_train.values()) + [kpt_gate, vitdet_train, lsj_train, precise_bn]
                                      + list(lvis_voc.values()) + [panoptic, cityscapes] for p in h["bwd"].values()]
                                   + [p["max_abs_err"] for pools in (options["bwd"], options["giou_bwd"]) for p in pools.values()]
                                   + [p["max_abs_err"] for pools in backbone_pools(backbones, "bwd") for p in pools.values()]
                                   + [p["max_abs_err"] for pools in dconv_densepose_pools(dconv_densepose, "bwd")
                                      for p in pools.values()]
                                   + [p["max_abs_err"] for pools in dconv_densepose_pools(hrfpn_bootstrap, "bwd")
                                      for p in pools.values()]
                                   + [p["max_abs_err"] for pools in dconv_densepose_pools(pointrend, "bwd")
                                      for p in pools.values()]),
                "library_ms": None,
                "per_step": "box pool + mask pool backward of one 8x800x1344 train step",
                "shapes": per_pool(train["bwd"], synthetic_bwd),
                "default_trainer": {**summed(trainer["bwd"]),
                                    "per_step": "box pool + mask pool backward of DefaultTrainer's first 16-image batch",
                                    "shapes": per_pool(trainer["bwd"])},
                "gate": {**summed(gate["bwd"]),
                         "per_step": "box pool + mask pool backward of the gate's first 8x64x64 float32 batch",
                         "shapes": per_pool(gate["bwd"])},
                "train_shapes": {name: {"res": r["res"], **{k: r["bwd"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "path")}} for name, r in train_shapes.items()},
                **{f"{name}_train": pools_entry(h["bwd"], "backward of " + HEAD_TRAIN_PER_STEP[name])
                   for name, h in heads_train.items()},
                "keypoint_gate": pools_entry(kpt_gate["bwd"], "backward of the box and keypoint pools of the keypoint gate's first batch"),
                "vitdet_train": pools_entry(vitdet_train["bwd"], "backward of the box and mask pools of the ViTDet-B train run's first batch"),
                "lsj_train": pools_entry(lsj_train["bwd"], "backward of the box and mask pools of the R50-FPN LSJ run's first batch"),
                "precise_bn": pools_entry(precise_bn["bwd"], "backward of the box and mask pools of the syncbn yaml run's first batch"),
                "lvis_train": pools_entry(lvis["bwd"], "backward of the box and mask pools of the LVIS DefaultTrainer run's first batch"),
                "lvis_vitdet_train": pools_entry(lvis_vitdet["bwd"], "backward of the box and mask pools of the ViTDet-B LVIS run's first batch"),
                "voc_train": pools_entry(voc["bwd"], "backward of the box pool of the VOC R50-FPN run's first batch"),
                "panoptic_train": pools_entry(panoptic["bwd"], "backward of the box and mask pools of the PanopticFPN DefaultTrainer run's first batch"),
                "fast_rcnn_train": pools_entry(options["bwd"], "backward of the box pool of the Fast R-CNN DefaultTrainer run's first batch"),
                "giou_train": pools_entry(options["giou_bwd"], "backward of the box and mask pools of the GIoU yaml run's first batch"),
                "cityscapes_train": pools_entry(cityscapes["bwd"], "backward of the box and mask pools of the Cityscapes run's first batch"),
                **backbone_entries(backbones, "bwd"),
                **dconv_densepose_entries(dconv_densepose, "bwd"),
                **dconv_densepose_entries(hrfpn_bootstrap, "bwd"),
                **dconv_densepose_entries(pointrend, "bwd"),
            },
            with_lvis_vitdet(attention_kernel(
                "flash_attention_fwd", "detectron2_tpu/ops/pallas/flash_attention.py:296", False,
                vitdet["attn_launches"], vitdet["attn_paths"], vitdet_train,
            ), lvis_vitdet),
            attention_kernel(
                "flash_attention_fwd_t", "detectron2_tpu/ops/pallas/flash_attention.py:189", True,
                vitdet["attn_t_launches"], vitdet["attn_t_paths"],
            ),
        ],
        "main_path": {
            **{k: main_path[k] for k in ("img_s", "batch_ms", "peak_gib")},
            **{k: train[k] for k in (
                "train_ms_per_step", "train_mean_ms_per_step", "train_img_s", "train_mean_img_s", "train_peak_gib",
            )},
            **{k: vitdet[k] for k in ("vitdet_img_s", "vitdet_batch_ms", "vitdet_peak_gib")},
            **{k: v for k, v in evaluation.items() if k.startswith("eval_")},
            **{k: v for k, v in trainer.items() if k.startswith("trainer_")},
            **{k: v for k, v in gate.items() if k.startswith("gate_")},
            **{f"{name}_{k}": h[k] for name, h in heads.items() for k in (
                "request_ms", "batch_ms", "batch_ms_range", "img_s", "peak_gib", "nms_rounds", "nms_ms")},
            **{k: v for k, v in kpt_eval.items() if k != "kpt_eval_launches"},
            **{k: v for k, v in tta.items() if k.startswith("tta_")},
            **{k: v for h in heads_train.values() for k, v in h.items() if "_train_" in k},
            **{k: v for k, v in kpt_gate.items() if k.startswith("kpt_gate_")},
            **{k: v for k, v in vitdet_train.items() if k.startswith("vitdet_train_")},
            **{k: v for k, v in lsj_train.items() if k.startswith("lsj_train_")},
            **{k: v for k, v in precise_bn.items() if k.startswith("precise_bn_")},
            **dense,
            **{k: v for r in lvis_voc.values() for k, v in r.items() if k.startswith(("lvis_", "voc_"))},
            **{k: v for r in seg.values() for k, v in r.items() if k.startswith(("seg_", "panoptic_", "semantic_"))},
            **{k: v for r in rcnn_options.values() for k, v in r.items()
               if k.startswith(("rcnn_", "fast_rcnn_", "giou_", "pred_boxes_", "cityscapes_"))},
            **{k: v for r in backbones.values() for k, v in r.items() if k.startswith(BACKBONE_KEYS)},
            **{k: v for r in dconv_densepose.values() for k, v in r.items() if k.startswith(DCONV_DENSEPOSE_KEYS)},
            **{k: v for r in hrfpn_bootstrap.values() for k, v in r.items() if k.startswith(HRFPN_BOOTSTRAP_KEYS)},
            **{k: v for r in pointrend.values() for k, v in r.items() if k.startswith(POINTREND_KEYS)},
            "phase_s": {str(k): v for k, v in seconds.items()},
            "total_s": total_s,
        },
        "card": smi,
    }
    for entry, name in zip(kernels["kernels"][2:], ("B3", "B4")):
        entry["panoptic_launches"] = 0  # checked in phase 32
        entry["semantic_launches"] = seg[33]["semantic_kernel_launches"][name]
        for path in (*rcnn_options[34]["launches"], "cityscapes", *BACKBONE_NAMES.values(), *DCONV_DENSEPOSE_NAMES.values(),
                     *HRFPN_BOOTSTRAP_NAMES.values(), "pointrend", "semantic_pointrend"):
            entry[f"{path}_launches"] = 0  # checked before every zeroing of the counts in phases 34-45 (attention_free)
    print(json.dumps(kernels), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

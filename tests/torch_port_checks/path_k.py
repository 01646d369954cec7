"""Path K's config: FixMatch on DenseNet-161.

The fields of ``configs/kaggle_semisupervised_real_3_1.yaml`` written out,
since the card's machine has no PyYAML, with ``MODEL.NAME`` the one field
changed: DenseNet-161, the backbone the reference trains through timm, in
ResNet-50's place; ``zoo.py`` holds them against the file on the CPU.
``chip_smoke.py`` runs them through path C's helpers (``path_c.py``). No
JAX, pandas, cv2, PIL or PyYAML.
"""

REAL_3_1_DENSENET = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 7,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "densenet161", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch", "IS_TRIPLET": False, "LOW_DIM": 128},
    "TRAIN": {"IS_FREEZE": False, "IS_SSL": True, "EPOCHS": 100,
              "BASE_LR": 0.001, "WARMUP_LR": 0.0005, "WARMUP_EPOCHS": 5,
              "DECAY_EPOCHS": 10, "OPT_NAME": "Adam", "FREQ_EVAL": 5,
              "SCH_NAME": "step", "LR_DECAY": 0.8, "USE_EMA": True,
              "EMA_DECAY": 0.999, "EVAL_STEP": 512, "CLS_WEIGHT": True,
              "THRES": 0.7, "T": 1.0, "LAMBDA_U": 2, "LAMBDA_C": 4},
}
PRESETS = {"kaggle_semisupervised_real_3_1": REAL_3_1_DENSENET}
# path K1's conditioning of the random DenseNet-161, its analog of a
# ResNet's small residual branch: in every BN that reads a dense block's
# concatenation (each later layer's norm1, the transition's norm,
# norm_final) the scale of the channels the block's own layers grew, its
# input's kept at 1. A BN per channel undoes any scale set on a layer's
# output (norm2 at 0.1 moved nothing), so the grown features are damped
# where they are read. At 1 the random net is chaotic: on the H100 host's
# CPU its float32 step read 1.1e-2..1.3e-2 from float64 and views rounded
# to bf16 moved it 0.42-0.47 (seeds 0-2); at 0.1, 2.8e-4 and 3.3e-2 on
# this repository's CPU check (seed 0)
GROWN_SCALE = 0.1

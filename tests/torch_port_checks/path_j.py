"""Path J's config: FixMatch on the SASA ResNet-50.

The fields of ``configs/kaggle_semisupervised_real_5.yaml`` written out,
since the card's machine has no PyYAML; ``ezbm.py`` holds them against
the file on the CPU. ``chip_smoke.py`` runs them through path C's helpers
(``path_c.py``). No JAX, pandas, cv2, PIL or PyYAML.
"""

REAL_5 = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 6,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50sasa", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch", "LOW_DIM": 64},
    "TRAIN": {"IS_SSL": True, "EPOCHS": 50, "OPT_NAME": "SGD",
              "SCH_NAME": "cosine", "USE_EMA": True, "EVAL_STEP": 512,
              "CLS_WEIGHT": True, "THRES": 0.7, "LAMBDA_U": 2},
}
PRESETS = {"kaggle_semisupervised_real_5": REAL_5}

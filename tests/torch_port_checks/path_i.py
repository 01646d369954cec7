"""Path I's configs: EfficientNet-B1 in the supervised trainer.

The fields of ``configs/kaggle_supervised_abnorm.yaml`` (the reference's
first stage, the abnormal/normal classifier: the plain branch, 2 classes,
no EMA) and ``configs/kaggle_supervised.yaml`` (``ModelwEmb`` over
EfficientNet-B1, the triplet branch) written out, since the card's machine
has no PyYAML; ``ezbm.py`` holds them against the files on the CPU. No
JAX, pandas, cv2, PIL or PyYAML.
"""

ABNORM = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 2, "NAME": "efficientnet_b1", "MARGIN": "None",
              "IS_TRIPLET": False},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 100, "BASE_LR": 0.001,
              "WARMUP_LR": 0.0005, "WARMUP_EPOCHS": 5, "DECAY_EPOCHS": 5,
              "OPT_NAME": "Adam", "FREQ_EVAL": 5, "SCH_NAME": "step",
              "LR_DECAY": 0.8, "USE_EMA": False, "CLS_WEIGHT": False,
              "THRES": 0.95},
}
SUPERVISED = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 6,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "efficientnet_b1", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch", "IS_TRIPLET": True},
    "TRAIN": {"TRAIN_RULE": "None", "IS_SSL": False, "EPOCHS": 150,
              "OPT_NAME": "Adam", "SCH_NAME": "cosine", "FREQ_EVAL": 2,
              "EVAL_STEP": 256, "CLS_WEIGHT": True, "THRES": 0.9,
              "LAMBDA_U": 1.0, "LAMBDA_C": 2.0, "USE_EMA": True},
}
PRESETS = {"kaggle_supervised_abnorm": ABNORM,
           "kaggle_supervised": SUPERVISED}
# the residual branch's last BN, scaled down to condition a random network
# (path C's method; ResNet's is ``bn3``)
LAST_BN = ".project_bn"

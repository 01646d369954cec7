"""Paths L and M's configs: Swin-T and the rest of the zoo in the
supervised trainer.

The fields of ``configs/kaggle_supervised_patho.yaml`` written out, since
the card's machine has no PyYAML, with ``MODEL.NAME`` the one field
changed: ``swin_tiny_patch4_window7_224`` (Swin-T, the timm name the
reference trains) for path L; path M puts each name of ``M_NAMES`` there.
``zoo.py`` holds them against the file on the CPU. No JAX, pandas, cv2,
PIL or PyYAML.
"""

PATHO_SWIN = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "swin_tiny_patch4_window7_224",
              "MARGIN": "None"},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 100, "OPT_NAME": "Adam",
              "SCH_NAME": "cosine", "FREQ_EVAL": 2, "CLS_WEIGHT": True,
              "USE_EMA": True},
}
PRESETS = {"kaggle_supervised_patho": PATHO_SWIN}
# path M: every registry name this slice ports but path K's and path L's
M_NAMES = ("resnet101", "resnet50se", "resnet101se", "resnet152se",
           "seresnext50", "resnet50cbam", "resnet50sa", "densenet121",
           "swin", "swin_small", "swin_mlp", "coatnet", "vit_lsa")

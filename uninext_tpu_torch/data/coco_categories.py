"""A copy of `uninext_tpu/data/coco_categories.py` (the port imports nothing of the JAX package).

The 80 COCO category names in contiguous-id order (standard list)."""

COCO_CATEGORIES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

# BDD100K MOT / MOTS categories (reference data/datasets/bdd100k.py)
BDD_TRACK_CATEGORIES = [
    "pedestrian", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

# YouTube-VIS 2019 categories (reference data/datasets/ytvis.py)
YTVIS_2019_CATEGORIES = [
    "person", "giant_panda", "lizard", "parrot", "skateboard", "sedan",
    "ape", "dog", "snake", "monkey", "hand", "rabbit", "duck", "cat", "cow",
    "fish", "train", "horse", "turtle", "bear", "motorbike", "giraffe",
    "leopard", "fox", "deer", "owl", "surfboard", "airplane", "truck",
    "zebra", "tiger", "elephant", "snowboard", "boat", "shark", "mouse",
    "frog", "eagle", "earless_seal", "tennis_racket",
]

"""Dataset category tables (the port's copy of
``tce_rvos_tpu/data/categories.py``): 65 Ref-YouTube-VOS classes, 78
Ref-DAVIS classes, as in the reference's datasets/categories.py."""

YTVOS_CATEGORIES = [
    "airplane", "ape", "bear", "bike", "bird", "boat", "bucket", "bus",
    "camel", "cat", "cow", "crocodile", "deer", "dog", "dolphin", "duck",
    "eagle", "earless_seal", "elephant", "fish", "fox", "frisbee", "frog",
    "giant_panda", "giraffe", "hand", "hat", "hedgehog", "horse", "knife",
    "leopard", "lion", "lizard", "monkey", "motorbike", "mouse", "others",
    "owl", "paddle", "parachute", "parrot", "penguin", "person", "plant",
    "rabbit", "raccoon", "sedan", "shark", "sheep", "sign", "skateboard",
    "snail", "snake", "snowboard", "squirrel", "surfboard", "tennis_racket",
    "tiger", "toilet", "train", "truck", "turtle", "umbrella", "whale",
    "zebra",
]

DAVIS_CATEGORIES = [
    "airplane", "backpack", "ball", "bear", "bicycle", "bird", "boat",
    "bottle", "box", "bus", "camel", "car", "carriage", "cat", "cellphone",
    "chamaleon", "cow", "deer", "dog", "dolphin", "drone", "elephant",
    "excavator", "fish", "goat", "golf cart", "golf club", "grass", "guitar",
    "gun", "helicopter", "horse", "hoverboard", "kart", "key", "kite",
    "koala", "leash", "lion", "lock", "mask", "microphone", "monkey",
    "motorcycle", "oar", "paper", "paraglide", "person", "pig", "pole",
    "potted plant", "puck", "rack", "rhino", "rope", "sail", "scale",
    "scooter", "selfie stick", "sheep", "skateboard", "ski", "ski poles",
    "snake", "snowboard", "stick", "stroller", "surfboard", "swing",
    "tennis racket", "tractor", "trailer", "train", "truck", "turtle",
    "varanus", "violin", "wheelchair",
]

ytvos_category_dict = {c: i for i, c in enumerate(YTVOS_CATEGORIES)}
davis_category_dict = {c: i for i, c in enumerate(DAVIS_CATEGORIES)}

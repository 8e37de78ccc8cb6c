"""ImageNet VID's label space (the class list of ``dtt.data.imagenet_vid``;
the dataset reader is not ported yet, see ROADMAP.md Queue 1 item 10)."""

# The 30 ImageNet VID categories (wnid -> readable name), devkit order.
VID_CLASSES = [
    ("n02691156", "airplane"), ("n02419796", "antelope"),
    ("n02131653", "bear"), ("n02834778", "bicycle"),
    ("n01503061", "bird"), ("n02924116", "bus"),
    ("n02958343", "car"), ("n02402425", "cattle"),
    ("n02084071", "dog"), ("n02121808", "domestic_cat"),
    ("n02503517", "elephant"), ("n02118333", "fox"),
    ("n02510455", "giant_panda"), ("n02342885", "hamster"),
    ("n02374451", "horse"), ("n02129165", "lion"),
    ("n01674464", "lizard"), ("n02484322", "monkey"),
    ("n03790512", "motorcycle"), ("n02324045", "rabbit"),
    ("n02509815", "red_panda"), ("n02411705", "sheep"),
    ("n01726692", "snake"), ("n02355227", "squirrel"),
    ("n02129604", "tiger"), ("n04468005", "train"),
    ("n01662784", "turtle"), ("n04530566", "watercraft"),
    ("n02062744", "whale"), ("n02391049", "zebra"),
]
CLASS_NAMES = ["__background__"] + [n for _, n in VID_CLASSES]

"""The paper's detector: YOLOv8 (n-scale) for stroke detection on CT, a copy
of ``repro.configs.yolov8_stroke``."""
from ..models.yolov8 import YOLOv8Config

FAMILY = "yolo"

CONFIG = YOLOv8Config(name="yolov8n-stroke", img_size=256, n_classes=2)

SMOKE = YOLOv8Config(name="yolov8-smoke", img_size=64, n_classes=2)

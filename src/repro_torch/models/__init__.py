from .hymba import HymbaBlock, HymbaConfig, HymbaLM
from .pix2pix import Pix2Pix, Pix2PixConfig, Pix2PixDiscriminator, Pix2PixGenerator
from .yolov8 import YOLOv8, YOLOv8Config

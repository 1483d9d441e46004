from .lm import LMBlock, LMConfig, TransformerLM
from .mamba2 import Mamba2Config, Mamba2LayerWrapped, Mamba2LM
from .hymba import HymbaBlock, HymbaConfig, HymbaLM
from .whisper import DecBlock, EncBlock, WhisperConfig, WhisperModel, sinusoid_pos
from .pix2pix import Pix2Pix, Pix2PixConfig, Pix2PixDiscriminator, Pix2PixGenerator
from .yolov8 import YOLOv8, YOLOv8Config

from .mast3r import Mast3rModel, TwoViewNet, PairPrediction
from .heads import DPTHead, DescriptorHead, postprocess_pointmap
from .vit import (DecoderBlock, EncoderBlock, Encoder,
                  InterleavedDecoder, patch_positions)
from .vggt import VGGTModel, VGGTNet
from .fast3r import Fast3RModel, Fast3RNet

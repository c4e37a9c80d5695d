"""Wire-level communication: embedding-exchange compression codecs."""
from .compression import (COMPRESSION_METHODS, CompressionConfig, Compressor,
                          FloatQuantizer, Int8Quantizer, TopKCompressor,
                          make_compressor, roundtrip_with_ef)

__all__ = [
    "COMPRESSION_METHODS", "CompressionConfig", "Compressor",
    "FloatQuantizer", "Int8Quantizer", "TopKCompressor", "make_compressor",
    "roundtrip_with_ef",
]

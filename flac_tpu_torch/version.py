__version__ = "0.1.0"

# Vendor string, the analog of FLAC__VENDOR_STRING in the reference
# (src/libFLAC/format.c:60 "reference libFLAC 1.2.1 20070917").
VENDOR_STRING = "flac_tpu 0.1.0 tpu-native"

"""TimeFloats core: FP8 codec and the forward scalar-product arithmetic."""

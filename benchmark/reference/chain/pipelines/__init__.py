"""Coherence blocks, the CDL point and the block-fading round."""

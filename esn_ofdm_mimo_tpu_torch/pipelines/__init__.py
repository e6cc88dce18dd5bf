"""Coherence-block machinery and the CDL pipeline of the port."""

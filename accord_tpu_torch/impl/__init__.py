"""Default implementations of the SPI layer (reference: accord.impl)."""

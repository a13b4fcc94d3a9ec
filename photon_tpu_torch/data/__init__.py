"""Training data: the device-resident batch."""

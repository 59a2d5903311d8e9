"""Runtime: the device-resident image stream."""

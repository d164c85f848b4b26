"""Models of the port: the U-Net generator and its layers."""

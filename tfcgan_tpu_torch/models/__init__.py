"""Models of the port: the U-Net generator and its layers, the PatchGAN
discriminator, LPIPS, the ViT and the affine STN."""

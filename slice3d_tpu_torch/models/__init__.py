"""Main-path models: layers, VGG16-BN trunk, slice U-Net, SDF head, SliceNet."""

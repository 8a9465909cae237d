"""Camera, shear-warp renderer, macrocells and the shadow lattice."""

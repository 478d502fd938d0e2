"""Host encoder, dense-lattice sweep and its CUDA kernel."""

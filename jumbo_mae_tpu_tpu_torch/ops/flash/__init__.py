"""Hand-written flash-attention kernels (the counterpart of the JAX
package's ``ops/pallas``)."""

"""The port's own copy of the JAX-free instrument model of `surfh_tpu.instrument`
(geometry, IFU, spectral blur, MIRI band and wavelength tables)."""

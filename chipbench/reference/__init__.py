"""The yardstick: the plain reference (digest spec, float32 models), the
card's peaks and the work counted from shapes.  Imports nothing of the
program, of JAX or of the JAX package."""

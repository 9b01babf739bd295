"""The prover split over ranks: torch.distributed counterparts of the JAX
package's parallel/ (a jax Mesh there, process groups here)."""

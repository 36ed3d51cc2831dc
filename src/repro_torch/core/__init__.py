"""The scheduling environment, the actor networks and the batched rollout."""

"""SAC's optimizer and the consistency distillation of the actor."""

"""Experience replay buffer (numpy ring buffer, host-side; a copy of
`repro/core/replay.py`)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_shape: Tuple[int, int],
                 action_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity,) + tuple(obs_shape), np.float32)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity,) + tuple(obs_shape), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.size = 0
        self.ptr = 0

    def add(self, obs, action, reward, next_obs, done):
        i = self.ptr
        self.obs[i] = obs
        self.action[i] = action
        self.reward[i] = reward
        self.next_obs[i] = next_obs
        self.done[i] = float(done)
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, obs, action, reward, next_obs, done):
        """Vectorized ring insertion of n transitions (one numpy scatter)."""
        n = len(reward)
        if n == 0:
            return
        idx = (self.ptr + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.action[idx] = action
        self.reward[idx] = reward
        self.next_obs[idx] = next_obs
        self.done[idx] = np.asarray(done, np.float32)
        self.ptr = int((self.ptr + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=batch)
        return {"obs": self.obs[idx], "action": self.action[idx],
                "reward": self.reward[idx], "next_obs": self.next_obs[idx],
                "done": self.done[idx]}

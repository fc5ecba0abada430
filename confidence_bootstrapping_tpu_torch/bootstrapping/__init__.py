"""Confidence Bootstrapping: replay buffer + rollout->filter->train loop."""

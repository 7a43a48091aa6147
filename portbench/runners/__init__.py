"""Runners, one module a kind of configuration (a config's `runner`)."""

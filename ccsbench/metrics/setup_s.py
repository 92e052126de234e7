"""Seconds from the process's start to the window's opening line."""


def read(obs):
    return obs["setup_s"]

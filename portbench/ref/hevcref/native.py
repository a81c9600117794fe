"""The reference has no native helpers: every caller takes its numpy path."""


def get_lib():
    return None


def get_dsp():
    return None

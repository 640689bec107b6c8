"""Logging helper (console + `<path_log>.txt`): a copy of
`monoloco_tpu/utils/logs.py`."""

import logging


def set_logger(path_log):
    logger = logging.getLogger(path_log)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(path_log + '.txt')
        fh.setLevel(logging.INFO)
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        formatter = logging.Formatter('%(message)s')
        fh.setFormatter(formatter)
        ch.setFormatter(formatter)
        logger.addHandler(fh)
        logger.addHandler(ch)
    return logger

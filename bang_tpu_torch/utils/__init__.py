"""Search parameters, recall and logging: the port's own copies of
bang_tpu/utils/{config,recall,logging}.py."""

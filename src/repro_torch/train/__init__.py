from repro_torch.train.loop import (TrainLoopConfig, TrainResult,
                                    make_train_step, train)

__all__ = ["TrainLoopConfig", "TrainResult", "make_train_step", "train"]

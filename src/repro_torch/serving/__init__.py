from repro_torch.serving.engine import (Request, ServeEngine,  # noqa: F401
                                        make_decode_step, make_prefill_step)

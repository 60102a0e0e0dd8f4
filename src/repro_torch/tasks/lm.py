"""``lm`` task: the transformer LM (``models/transformer.py``): dense and
MoE decoders, the SSM and hybrid stacks (xLSTM, zamba2), the
encoder-decoder and the VLM, whose batches carry
``"frontend"`` embeddings beside the tokens.  Stateless: the model holds
no buffers."""
from __future__ import annotations

from repro_torch.core.config import Experiment
from repro_torch.core.cost import lm_cost
from repro_torch.core.slu import lm_uniforms
from repro_torch.models import transformer as T
from repro_torch.tasks import Task, eval_logits, register


def _init(exp: Experiment, seed: int = 0, device=None) -> T.TransformerLM:
    return T.TransformerLM(exp.model, exp.e2, seed=seed, device=device)


def _make_loss(exp: Experiment):
    remat = exp.train.remat

    def loss(model, batch, key, keep=None, slu_u=None):
        if keep is not None:
            raise ValueError("the LM draws its SLU decisions from the step "
                             "key; it takes no injected keep mask")
        return T.lm_loss(model, batch, key, remat=remat, slu_u=slu_u)
    return loss


def _slu_uniforms(exp: Experiment, key):
    return lm_uniforms(key, exp.model)


def _make_predict(exp: Experiment):
    def predict(model, batch):
        return eval_logits(model, batch["tokens"],
                           frontend=batch.get("frontend"))
    return predict


LM_TASK = register(Task(name="lm", init=_init, make_loss=_make_loss,
                        make_predict=_make_predict,
                        slu_uniforms=_slu_uniforms,
                        cost=lambda exp: lm_cost(exp.model,
                                                 exp.train.seq_len)))

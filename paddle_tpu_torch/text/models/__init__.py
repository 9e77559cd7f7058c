"""paddle_tpu_torch.text.models — the port's language models."""
from .bert import BertConfig, BertForPretraining, BertModel, bert_base
from .ernie import ErnieConfig, ErnieForPretraining, ErnieModel
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt2_345m, gpt2_small

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small",
           "gpt2_345m", "BertConfig", "BertModel", "BertForPretraining",
           "bert_base", "ErnieConfig", "ErnieModel", "ErnieForPretraining"]

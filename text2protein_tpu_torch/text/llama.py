"""A causal LM driven with a prefix of query embeddings (the port's copy of
text2protein_tpu/text/llama.py, which is torch code already).

`embed_with_query` embeds the token ids with the model's own embedding
table and puts `query_embeds` in front of them, with an attention mask of
ones for the prefix; `forward_with_query` and `generate_with_query` run the
model or its generation from those embeddings. Works with any Hugging Face
causal LM loaded from local files; `transformers` is needed only by the
model the caller passes.
"""

from __future__ import annotations

import torch


def embed_with_query(model, input_ids, query_embeds=None, attention_mask=None):
    """Token ids (and an optional query prefix) -> (inputs_embeds,
    attention_mask)."""
    inputs_embeds = model.get_input_embeddings()(input_ids)
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.long,
                                    device=input_ids.device)
    if query_embeds is not None:
        query_embeds = query_embeds.to(inputs_embeds.dtype)
        inputs_embeds = torch.cat([query_embeds, inputs_embeds], dim=1)
        prefix_mask = torch.ones(query_embeds.shape[:2],
                                 dtype=attention_mask.dtype,
                                 device=attention_mask.device)
        attention_mask = torch.cat([prefix_mask, attention_mask], dim=1)
    return inputs_embeds, attention_mask


def forward_with_query(model, input_ids, query_embeds=None, **kwargs):
    """Run the causal LM on tokens with a query-embedding prefix."""
    inputs_embeds, attention_mask = embed_with_query(
        model, input_ids, query_embeds, kwargs.pop("attention_mask", None))
    return model(inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                 **kwargs)


def generate_with_query(model, input_ids, query_embeds=None,
                        **generate_kwargs):
    """Generation conditioned on a query-embedding prefix."""
    inputs_embeds, attention_mask = embed_with_query(
        model, input_ids, query_embeds,
        generate_kwargs.pop("attention_mask", None))
    return model.generate(inputs_embeds=inputs_embeds,
                          attention_mask=attention_mask, **generate_kwargs)

"""PC inpainting (counterpart of text2protein_tpu/diffusion/inpainting.py).

A thin wrapper over the PC sampler's `inpainting` condition: the known
region is clamped to the (un-noised) reference map after every corrector
and predictor step.
"""

from __future__ import annotations

from .sampling import get_pc_sampler


def get_pc_inpainter(sde, model, shape, predictor="reverse_diffusion",
                     corrector="langevin", snr=0.17, n_steps=1,
                     probability_flow=False, denoise=True, eps=1e-5,
                     num_steps=None):
    """Returns inpainter(coords_6d, mask_inpaint, generator=None,
    context=None, context_mask=None, noise_fn=None) -> (samples, nfe).

    `coords_6d`: (B, N, N, C) reference map; `mask_inpaint`: (B, N, N)
    bool, True = region to generate; the False region is `coords_6d`.
    Draws as the PC sampler's (`noise_fn`, else `generator`).
    """
    sampler = get_pc_sampler(
        sde, model, shape, predictor=predictor, corrector=corrector, snr=snr,
        n_steps=n_steps, probability_flow=probability_flow, denoise=denoise,
        eps=eps, num_steps=num_steps,
    )

    def inpainter(coords_6d, mask_inpaint, generator=None, context=None,
                  context_mask=None, noise_fn=None):
        condition = {"inpainting": {"coords_6d": coords_6d,
                                    "mask_inpaint": mask_inpaint}}
        return sampler(generator, condition=condition, context=context,
                       context_mask=context_mask, noise_fn=noise_fn)

    return inpainter

// flash_attention_train: the training forward of flash_attention, the fp
// forms that train (causal self-attention, the encoder's bidirectional
// attention, the decoder's cross-attention over T keys), also writing
// each row's log-sum-exp lse [BH, S] f32 for flash_attention_bwd.cu
// (which recomputes P from it).
//
// Replaces no TPU kernel beyond flash_attention's own (_flash_kernel,
// repro/kernels/flash_attention.py:67): it is flash_attention.cu compiled
// with FLASH_TRAIN defined, so its kernels are the serving kernels' code
// plus one store a row (and two warpgroups in flash_tc_kernel at D =
// 128), in a library of its own: the serving library is built from the
// unchanged source. What bounds it is what bounds the serving forward
// (operations at the training shapes); see flash_attention.cu.
#define FLASH_TRAIN
#include "flash_attention.cu"

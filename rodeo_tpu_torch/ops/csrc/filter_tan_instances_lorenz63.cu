// The instances of K11a (filter_batch_tan.cuh) for Lorenz63 at q = 3, under
// kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<Lorenz63, 3>;

}  // namespace rodeo
